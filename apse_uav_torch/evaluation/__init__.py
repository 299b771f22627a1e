"""Evaluation stack of the port: the RLE mask codec, MOTS formats and metrics,
and the tracker's MOTS export."""
