"""``prefill_chunk_ms``: the mean of the program's ``prefill_chunk`` spans
(``serving/workers.py:PrefillWorker.advance_chunk``, host clock: the
enqueue of one chunk through every layer), ms."""


def read(out: dict):
    d = [s["end"] - s["start"] for s in out.get("spans", ())
         if s["name"] == "prefill_chunk"]
    return None if not d else 1e3 * sum(d) / len(d)
