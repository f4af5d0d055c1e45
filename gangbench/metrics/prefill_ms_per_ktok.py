"""Prefill wall time per thousand prompt tokens in the window: the spans
around ``add_request`` (prefill and first token) or the batched
``prefill_fn`` (to the host read of the first tokens), summed, over the
prompt tokens they took."""


def read(run):
    pre = run.prefills()
    tokens = sum(b * n for _, b, n in pre)
    if not tokens:
        return None
    return 1e3 * sum(s.dur for s, _, _ in pre) / (tokens / 1e3)
