"""``ttft_p90_ms``: the 90th percentile of the time to first token over
every request due in the window, from its scheduled arrival (open loop),
ms. A request that was rejected or never produced its first token counts
as missing: its time runs from its arrival to the end of the window, a
lower bound of what it waited.

Read from the run's own records, on the host's clock. The p90 is the
highest percentile with ten of the chat window's 150 requests beyond
it. Its spread from run to run is too wide for any bound an end-to-end
metric may take, so it stands here, beside the tails that are bounded."""
from portbench.yardstick.stats import percentile


def read(out: dict):
    records = out.get("records", ())
    if not records:
        return None
    end = out["window"][1]
    return 1e3 * percentile([(r["first"] if r["first"] is not None else end)
                             - r["arrival"] for r in records], 90)
