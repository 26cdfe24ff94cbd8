"""``decode_dispatch_ms``: the mean of the ``dispatch`` spans on the decode
worker's track (``serving/workers.py:DecodeWorker`` step: the host's
enqueue of one decode step through every layer, before its sync), ms."""


def read(out: dict):
    d = [s["end"] - s["start"] for s in out.get("spans", ())
         if s["name"] == "dispatch" and s["track"].startswith("decode/")]
    return None if not d else 1e3 * sum(d) / len(d)
