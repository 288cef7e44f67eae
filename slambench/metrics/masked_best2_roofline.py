"""Share of its roofline that the masked_best2 kernel reached in the profiled
slice: the least time of every launch (``work.least_seconds`` of the
call's own inputs) over the launches' device time, in %."""


def read(r):
    least = r.get("slice_least", {}).get("hamming_best2", [])
    spent = (r.get("slice") or {}).get("launches", {}).get("hamming_best2", [])
    if not least or len(least) != len(spent) or sum(spent) <= 0:
        return None
    return 100.0 * sum(least) / sum(spent)
