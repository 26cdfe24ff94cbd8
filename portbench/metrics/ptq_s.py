"""``ptq_s``: seconds of the program's PTQ of every projection
(``quant/ptq.py:quantize_tree``), on the host's clock around the call,
ending in a device sync. Moves ``setup_s``."""


def read(out: dict):
    return out.get("ptq_s")
