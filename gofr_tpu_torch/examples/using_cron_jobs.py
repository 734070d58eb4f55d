"""Cron jobs on the port — counterpart of
``examples/using_cron_jobs/main.py``: a 6-field schedule fires every
second and ``GET /ticks`` reports how often it ran.

    python -m gofr_tpu_torch.examples.using_cron_jobs
"""

from __future__ import annotations

from ..app import App, new_app
from ..context import Context

__all__ = ["main"]

_state = {"ticks": 0}


async def count(ctx: Context):
    _state["ticks"] += 1
    ctx.logger.infof("cron tick %d", _state["ticks"])


async def ticks(ctx: Context):
    return {"ticks": _state["ticks"]}


def main() -> App:
    app = new_app()
    app.add_cron_job("* * * * * *", "counter", count)  # every second
    app.get("/ticks", ticks)
    return app


if __name__ == "__main__":
    main().run()
