"""Multi-rank training of the port against one rank: ``python3
scripts/torch_train_ranks.py [--ranks 4] [--device cpu]``.

Runs ``repro_torch.launch.train`` (reduced qwen2-7b, f32) with
``--ranks N`` (NCCL, one card a rank; gloo with ``--device cpu``) and a
failure injected at step 7, then with one rank, then resumes the N-rank
run's checkpoint in a 1-rank run. Prints each step's losses and one
JSON line: the largest relative difference of the N-rank and the resumed
losses from the 1-rank ones, and whether it is within 1e-5 (the loss
tolerance of ``tests/test_torch_checkpoint_mesh.py``); exits 1 if not.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import train  # noqa: E402

RTOL = 1e-5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    work = tempfile.mkdtemp(prefix="train_ranks_")
    base = ["--device", args.device, "--batch", "8", "--seq", "128",
            "--ckpt-every", "5"]
    try:
        many = train.main(base + [
            "--ranks", str(args.ranks), "--steps", "12", "--fail-at-step",
            "7", "--ckpt-dir", os.path.join(work, "many")]).metrics_log
        one = {m["step"]: m["loss"] for m in train.main(base + [
            "--steps", "14", "--ckpt-dir",
            os.path.join(work, "one")]).metrics_log}
        resumed = train.main(base + ["--steps", "14", "--ckpt-dir",
                                     os.path.join(work, "many")]).metrics_log
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rel = lambda m: abs(m["loss"] - one[m["step"]]) / abs(one[m["step"]])  # noqa: E731
    for name, log in ((f"{args.ranks} ranks", many), ("resumed", resumed)):
        print(f"[ranks] {name}: " + ", ".join(
            f"{m['step']}: {m['loss']:.6f}" for m in log))
    out = {"ranks": args.ranks, "device": args.device,
           "steps_many": [m["step"] for m in many],
           "steps_resumed": [m["step"] for m in resumed],
           "max_rel_many": max(rel(m) for m in many),
           "max_rel_resumed": max(rel(m) for m in resumed)}
    out["ok"] = (out["steps_many"] == list(range(7)) + list(range(5, 12))
                 and out["steps_resumed"] == [10, 11, 12, 13]
                 and max(out["max_rel_many"], out["max_rel_resumed"]) <= RTOL)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
