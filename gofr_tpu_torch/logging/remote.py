"""Remote log level — counterpart of ``gofr_tpu/logging/remote.py``.

``App.start`` starts a ``RemoteLevelUpdater`` when ``REMOTE_LOG_URL`` is
set: an asyncio task that fetches the URL every
``REMOTE_LOG_FETCH_INTERVAL`` seconds (15 by default) and applies the
level it names to the app's logger. The accepted bodies are JAX's:
``{"data": [{"serviceName": ..., "logLevel": {"LOG_LEVEL": "DEBUG"}}]}``,
its flat variants and a bare string.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any

from . import Level

__all__ = ["RemoteLevelUpdater", "extract_level"]


def extract_level(payload: Any) -> str | None:
    """The level string of a fetched body, or None."""
    if isinstance(payload, str):
        return payload
    if isinstance(payload, dict):
        data = payload.get("data", payload)
        if isinstance(data, list):
            data = data[0] if data else {}
        if isinstance(data, dict):
            lvl = (data.get("logLevel") or data.get("LOG_LEVEL")
                   or data.get("level"))
            if isinstance(lvl, dict):
                lvl = lvl.get("LOG_LEVEL") or lvl.get("level")
            if isinstance(lvl, str):
                return lvl
    return None


class RemoteLevelUpdater:
    """Polls ``url`` and applies level changes to ``logger``."""

    def __init__(self, logger, url: str, interval_s: float = 15.0) -> None:
        self._logger = logger
        self.url = url
        self.interval = interval_s
        self._task: asyncio.Task | None = None
        self.polls = 0

    async def poll_once(self) -> bool:
        """One fetch and apply; True when a level was applied."""
        import aiohttp

        try:
            async with aiohttp.ClientSession(
                    timeout=aiohttp.ClientTimeout(total=5)) as session:
                async with session.get(self.url) as resp:
                    payload = await resp.json(content_type=None)
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError) as exc:
            self._logger.debugf("remote log level fetch failed: %s", exc)
            return False
        finally:
            self.polls += 1
        name = extract_level(payload)
        if not name:
            return False
        try:
            level = Level[name.upper()]
        except KeyError:
            self._logger.warnf("remote log level %r is not a level", name)
            return False
        if level != self._logger.level:
            self._logger.infof("remote log level change -> %s", name.upper())
            self._logger.change_level(level)
        return True

    def start(self) -> None:
        async def loop():
            while True:
                await self.poll_once()
                await asyncio.sleep(self.interval)

        self._task = asyncio.get_running_loop().create_task(
            loop(), name="gofr-remote-log-level")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
