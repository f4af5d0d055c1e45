"""Mean wall time of a decode step in the window: the span around
``ServingEngine.decode_step``, or around ``decode_fn`` and the host read
of the next tokens; total time over steps."""


def read(run):
    steps = run.decodes()
    if not steps:
        return None
    return 1e3 * sum(s.dur for s, _ in steps) / len(steps)
