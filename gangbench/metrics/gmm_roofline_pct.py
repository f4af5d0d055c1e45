"""moe_gmm's share of its roofline: the summed bound of the grouped
products (gate, up, down a layer) that the window's prefills and decode
steps need, over the summed device time of the moe_gmm kernels that ran
inside them, in %. Rows: each token's top-k pairs (prompt tokens, and at
a decode step its busy slots' tokens); experts read: those the tokens
reach in expectation under uniform routing (every expert for a prompt of
a few hundred tokens)."""
from gangbench.harness import readers as R
from gangbench.harness import work


def _bound(run, tokens):
    m = run.model
    e = m["moe"]
    rows = tokens * e["top_k"]
    used = work.experts_used(tokens, e["top_k"], e["n_experts"])
    D, F, it = m["d_model"], m["d_ff"], R.ITEMSIZE[m["dtype"]]
    up = work.gmm_work(rows, used, D, F, it)
    down = work.gmm_work(rows, used, F, D, it)
    t_up = R.bound(run, *up, m["dtype"])
    t_down = R.bound(run, *down, m["dtype"])
    if t_up is None or t_down is None:
        return None
    return m["n_layers"] * (2 * t_up + t_down)


def read(run):
    if run.trace is None or run.model["family"] != "moe":
        return None
    spans, total = [], 0.0
    for s, b, n in run.prefills():
        spans.append(s)
        t = _bound(run, b * n)
        if t is None:
            return None
        total += t
    for s, pos in run.decodes():
        spans.append(s)
        total += _bound(run, len(pos))
    return R.share(total, R.ops_in_spans(run, R.GMM, spans))
