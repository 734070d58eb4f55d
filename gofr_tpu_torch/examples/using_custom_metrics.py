"""Custom metrics on the port — counterpart of
``examples/using_custom_metrics/main.py``: a counter, an up-down counter,
a gauge and a histogram registered at start, updated by ``POST
/transaction`` and ``POST /return``, scraped at ``METRICS_PORT``'s
``/metrics``.

    python -m gofr_tpu_torch.examples.using_custom_metrics
"""

from __future__ import annotations

import time

from ..app import App, new_app
from ..context import Context

__all__ = ["main"]

TRANSACTION_SUCCESS = "transaction_success"
TRANSACTION_TIME = "transaction_time"
TOTAL_CREDIT_DAY_SALES = "total_credit_day_sale"
PRODUCT_STOCK = "product_stock"


async def transaction(ctx: Context):
    start = time.perf_counter()
    body = await ctx.bind()
    m = ctx.metrics()
    m.increment_counter(TRANSACTION_SUCCESS)
    m.delta_updown_counter(TOTAL_CREDIT_DAY_SALES,
                           float(body.get("amount", 0)))
    m.set_gauge(PRODUCT_STOCK, float(body.get("stock_left", 0)))
    m.record_histogram(TRANSACTION_TIME, (time.perf_counter() - start) * 1e3)
    return "transaction successful"


async def return_order(ctx: Context):
    body = await ctx.bind()
    # a return reverses the day's credit sale total
    ctx.metrics().delta_updown_counter(TOTAL_CREDIT_DAY_SALES,
                                       -float(body.get("amount", 0)))
    return "return successful"


def main() -> App:
    app = new_app()
    m = app.container.metrics_manager
    m.new_counter(TRANSACTION_SUCCESS, "count of successful transactions")
    m.new_updown_counter(TOTAL_CREDIT_DAY_SALES, "total credit sales in a day")
    m.new_gauge(PRODUCT_STOCK, "number of products in stock")
    m.new_histogram(TRANSACTION_TIME, "time taken by a transaction (ms)",
                    buckets=(5, 10, 15, 20, 25, 35))
    app.post("/transaction", transaction)
    app.post("/return", return_order)
    return app


if __name__ == "__main__":
    main().run()
