"""ms a frame of ``ArucoPipeline.front`` (K5, K3, K2, tile selection, K4, the
candidate stage with K1, pose) alone on one call's frames, host clock
ending in a synchronize."""


def read(record):
    return record.get("front_ms")
