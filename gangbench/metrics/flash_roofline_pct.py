"""flash_attention's share of its roofline: the summed bound of every
prefill attention the window ran (``work.flash_work`` over the shapes of
the prefills, every layer) over the summed device time of the flash
kernels that ran inside those prefills, in %."""
from gangbench.harness import readers as R
from gangbench.harness import work


def read(run):
    m = run.model
    if run.trace is None or m["family"] not in ("dense", "moe"):
        return None
    pre = run.prefills()
    total = 0.0
    for _, b, n in pre:
        ops, nbytes = work.flash_work(
            b, n, n, m["n_heads"], m["n_kv_heads"], m["head_dim"], True,
            m.get("window", 0), R.ITEMSIZE[m["dtype"]])
        t = R.bound(run, ops, nbytes, m["dtype"])
        if t is None:
            return None
        total += m["n_layers"] * t
    return R.share(total, R.ops_in_spans(run, R.FLASH,
                                              [s for s, _, _ in pre]))
