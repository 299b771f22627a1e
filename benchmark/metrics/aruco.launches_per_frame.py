"""Device kernels a frame in the profiled stretch of the window's loop."""


def read(record):
    if not record.get("frames") or not record.get("launches"):
        return None
    return record["launches"] / record["frames"]
