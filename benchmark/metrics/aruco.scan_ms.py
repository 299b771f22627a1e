"""ms a frame of ``ArucoPipeline.scan`` (the temporal state machine) alone on
one call's front, host clock ending in a synchronize."""


def read(record):
    return record.get("scan_ms")
