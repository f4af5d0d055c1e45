"""The port's benchmark aggregator, the counterpart of the JAX package's
``benchmarks/run.py``: the sections that do device work, in its order and
under its ``== name ==`` headers.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
        [--duration 5]

- fig1: DAVE-2's batch of 8 over 1 / 2 / 4 streams, and the DNN beside a
  memory co-runner (``fig1_parallelization.run``);
- fig6: the DNN quantum's percentiles under Solo, Co-Sched and RT-Gang
  through the gang executor, ``--duration`` seconds a mode
  (``fig6_dnn_cdf.run``);
- roofline: the H100 terms of every dry-run cell in
  ``results/dryrun_torch/`` (``roofline_bench.run``), or the sweep
  command that writes them where there are none.

fig4, fig5, table3 and the simulator engines' bench do no device work and
are not ported: they run on the shared core from the JAX package's
aggregator, and one line here says so. Without ``--device cpu`` the run
is on the card and raises where there is none. ``main`` returns the
sections' rows.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks import fig1_parallelization, fig6_dnn_cdf
from repro_torch.benchmarks import roofline_bench
from repro_torch.device import resolve_device

SWEEP_HINT = "(run `python -m repro_torch.launch.sweep` to populate)"
SIM_NOTE = ("== fig4, fig5, table3, sim engines: no device work, not "
            "ported; `PYTHONPATH=src python -m benchmarks.run` prints them "
            "from the JAX package ==")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="fig6's seconds a mode")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.time()
    print(SIM_NOTE)

    print("== fig1 (DNN parallelization + co-run, paper §II) ==")
    fig1 = fig1_parallelization.run(dev)
    for r in fig1:
        print(r)

    print("== fig6 (DNN latency CDFs: solo/cosched/rtgang, paper §V-C) ==")
    fig6 = fig6_dnn_cdf.run(duration=args.duration, device=dev)
    for k, v in fig6.items():
        print(k, v)

    print("== roofline (per arch x shape x mesh; dry-run cache) ==")
    rows = roofline_bench.run()
    for r in rows:
        print(r)
    if not rows:
        print(SWEEP_HINT)

    print(f"== done in {time.time() - t0:.1f}s ==")
    return {"fig1": fig1, "fig6": fig6, "roofline": rows}


if __name__ == "__main__":
    main()
