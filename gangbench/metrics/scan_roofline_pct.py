"""ssd_scan's share of its roofline: the summed bound of the chunked scan
of every prefill of the window (``work.ssd_work``, every layer; the scan
runs in float32, against a third of the TF32 rate) over the summed device
time of the ssd_scan kernels that ran inside those prefills, in %."""
from gangbench.harness import readers as R
from gangbench.harness import work


def read(run):
    m = run.model
    if run.trace is None or m["family"] != "ssm":
        return None
    s = m["ssm"]
    H = s["expand"] * m["d_model"] // s["head_dim"]
    pre = run.prefills()
    total = 0.0
    for _, b, n in pre:
        ops, nbytes = work.ssd_work(b, n, H, s["head_dim"], s["state_dim"],
                                    s["chunk"], 4)
        t = R.bound(run, ops, nbytes, "float32")
        if t is None:
            return None
        total += m["n_layers"] * t
    return R.share(total, R.ops_in_spans(run, R.SSD,
                                              [sp for sp, _, _ in pre]))
