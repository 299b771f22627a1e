"""The device's idle share of the profiled stretch, %: 100 (1 - busy / wall),
busy being the union of the kernels' intervals in the profiler's trace."""


def read(record):
    if not record.get("window_s") or not record.get("busy_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
