"""Frame and data parallelism over several devices (see ``mesh`` and ``dp``)."""
