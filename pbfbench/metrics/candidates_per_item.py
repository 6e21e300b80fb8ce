"""candidates_per_item: the (own row, candidate) pairs that the program's
window plans handed the pair kernels over the traced segment
(`Stepper.counters["plan_candidates"]`) per work item of their tables
(`Stepper.counters["pair_items"]`), both over the profiler session
(`timing.last_session()`): how full a work item is. A full item is own x
seg_len pairs (32,768 at own 64 and seg 512); a chunk's last segment, and
a sparse chunk's only one, is shorter. A program without the item counter
gives no number."""

from pbfbench import stages


def read(ctx):
    s = stages.session(ctx)
    if s is None or not s.get("pair_items") or "plan_candidates" not in s:
        return None
    return s["plan_candidates"] / s["pair_items"]
