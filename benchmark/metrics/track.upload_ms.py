"""ms a frame of the upload of one batch, the ``Preprocessor`` (K3's RGB mode)
and the resize's two products, alone between synchronizes."""


def read(record):
    return record.get("upload_ms")
