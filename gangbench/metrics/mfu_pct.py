"""Model FLOPs of every prefill and decoded token of the window
(``harness.flops``, from the configuration) over the card's peak rate
times the summed wall time of the RT quanta of the window, in %."""
from gangbench.harness import flops, work


def read(run):
    p = work.peaks(run.device_kind)
    quanta = run.in_window("quantum")
    if p is None or not quanta:
        return None
    m = run.model
    total = sum(flops.prefill(m, b, n) for _, b, n in run.prefills())
    total += sum(flops.decode_token(m, pos) for _, ps in run.decodes()
                 for pos in ps)
    rate = p["bf16" if m["dtype"] == "bfloat16" else "f32"]
    return 100.0 * total / (rate * sum(s.dur for s in quanta))
