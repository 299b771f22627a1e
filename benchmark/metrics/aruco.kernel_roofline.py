"""K1-K5's share of their roofline in the profiled stretch, %: the least
time their calls' bytes and operations need on the card
(``benchkit/yardstick.py``) over their kernels' device time."""


def read(record):
    if not record.get("kernel_s") or not record.get("kernel_bound_s"):
        return None
    return 100.0 * record["kernel_bound_s"] / record["kernel_s"]
