"""How the joint Gram's summation precision moves the mixed GLS step.

    python profiling/torch_gram_precision.py [--device cpu|cuda] [n ...]

For the bench pulsar (bench.py's par, 1-AU orbit) at each TOA count, one
mixed step of pint_tpu_torch is compared with the exact-f64 step from the
same x, with the joint Gram formed three ways from the same inputs:

- ``f32 sums``: f32 values, 128-row f32 sub-chunk sums, f64 across chunks
  (the TPU kernel's 'highest' rung);
- ``f64 sums``: the same f32 values, products summed in f64 (what
  ``pint_tpu_torch/csrc/fused_gram_joint.cu`` computes);
- ``f64``: the exact f64 Gram.

Prints, per variant, the bench gates' metrics: dx relative to the largest
component, chi2 relative, normalized covariance relative to its largest
entry, and the largest relative uncertainty difference.  These are
accuracy numbers, valid on any device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import pint_tpu_torch.ops.fused_gram as fused_gram  # noqa: E402
from chip_smoke import BENCH_PAR, SIM, rel, step_inputs  # noqa: E402
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    gls_step_woodbury,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.ops import solve_policy  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

F32, F64 = torch.float32, torch.float64


def _f32_values(T, A, w):
    s32 = torch.sqrt(w).to(F32)
    return torch.cat([T.to(F32), A.to(F32)], dim=1) * s32[:, None]


def gram_f32_sums(T, A, w, precision="highest"):
    Y = _f32_values(T, A, w)
    n, q = Y.shape
    n_pad = -(-n // 128) * 128
    Yp = torch.zeros((n_pad, q), dtype=F32, device=Y.device)
    Yp[:n] = Y
    Yb = Yp.reshape(-1, 128, q)
    G = torch.sum(torch.bmm(Yb.transpose(1, 2), Yb).to(F64), dim=0)
    k = T.shape[1]
    return G[:k, :k], G[:k, k:], G[k:, k:]


def gram_f64(T, A, w, precision="highest"):
    Y = torch.cat([T, A], dim=1) * torch.sqrt(w)[:, None]
    G = Y.T @ Y
    k = T.shape[1]
    return G[:k, :k], G[:k, k:], G[k:, k:]


VARIANTS = {
    "f32 sums": gram_f32_sums,
    "f64 sums": fused_gram.fused_gram_joint_plain,
    "f64": gram_f64,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("ntoa", nargs="*", type=int,
                    default=[4096, 16384, 32768])
    args = ap.parse_args()
    dev = torch.device(args.device)
    if not (solve_policy.fused_interior_active(dev)
            and solve_policy.ir_active(dev)):
        sys.exit("set PINT_TPU_TORCH_FUSED_INTERIOR=force and "
                 "PINT_TPU_TORCH_SOLVE_IR=force to run the mixed step here")
    for n in args.ntoa:
        model, toas = make_test_pulsar(BENCH_PAR, ntoa=n, device=dev, **SIM)
        cm = model.compile(toas, device=dev)
        step_args = step_inputs(cm, cm.x0())
        dx_f, (cov_f, _), chi_f, _ = gls_step_woodbury(
            *step_args, normalized_cov=True)
        sig_f = torch.sqrt(torch.diagonal(cov_f))
        for name, gram in VARIANTS.items():
            fused_gram.fused_gram_joint = gram
            dx_m, (cov_m, _), chi_m, _ = gls_step_woodbury_mixed(
                *step_args, normalized_cov=True)
            sig_m = torch.sqrt(torch.diagonal(cov_m))
            print(f"n={n:6d} {name:9s} dx {rel(dx_m, dx_f):.3e}  chi2 "
                  f"{abs(float(chi_m - chi_f)) / abs(float(chi_f)):.3e}  "
                  f"cov {rel(cov_m, cov_f):.3e}  unc "
                  f"{float(torch.max(torch.abs(sig_m - sig_f) / sig_f)):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
