"""``freeze_flush_ms``: the host time of the page-freeze ``flush`` spans
(``serving/workers.py:DecodeWorker._flush_freezes`` on ``freeze/w0``:
the dispatch of the batched kmeans_ls solve of the queued pages) summed
and divided by the decode steps (``decode_step`` spans), ms a step."""


def read(out: dict):
    spans = out.get("spans", ())
    flush = sum(s["end"] - s["start"] for s in spans
                if s["name"] == "flush" and s["track"].startswith("freeze/"))
    steps = sum(1 for s in spans if s["name"] == "decode_step")
    return None if not steps else 1e3 * flush / steps
