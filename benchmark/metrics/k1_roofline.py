"""``ops.kde_cuda`` layer: K1's share of its least time, in %, over the
profiled inference.  Each generation t >= 1 launches K1 once a model,
over the generation's n query rows against the model's pdf support
(``kde_support``); their frozen bounds (``reference/k1_bound.py``) are
summed and divided by the device time of K1's four kernels in the
trace.  A support that is not grid-compressed is padded to a power of
two: it counts the rows these inputs need, at most the previous
generation's population.  The device time is every K1 kernel of the
trace, work that the kept rows do not count included (such as a
rewound block's), so that waste lowers the share.  Silent without a
trace, or where a row's launches are not one a model (their shapes
would be unknown)."""

from reference.k1_bound import bound_seconds

KERNELS = ("kde_prep_kernel", "kde_pack_kernel", "kde_partial_kernel",
           "kde_merge_kernel")


def read(ctx: dict):
    tr = ctx["trace"]
    ops = tr.get("device_ops")
    if not ops:
        return None
    dims = [len(box) for box in ctx["config"]["prior_boxes"]]
    bound, prev = 0.0, None
    for r in tr["profiled_rows"]:
        sup = r.get("kde_support") or []
        if sup:
            if r.get("kde_launches") != len(sup) or prev is None:
                return None
            for d, s in zip(dims, sup):
                rows = int(s["rows"])
                if not s.get("compressed"):
                    rows = min(rows, int(prev["n"]))
                bound += bound_seconds(int(r["n"]), rows, d)
        prev = r
    spent = sum(s for name, s in ops.items()
                if any(k in name for k in KERNELS))
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
