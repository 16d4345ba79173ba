"""The reference kernels' three precision rungs in the port.

``fused_gram_joint``, ``fourier_gram`` and ``fourier_apply`` of the JAX
package take ``precision='highest'|'high'|'default'``, the bf16 pass
ladder of the TPU's matrix unit.  The port takes the three names and
computes, for each, exact products of the f32 operands summed in f64.
Each port result is held to the reference's result at the same rung
(Pallas in interpret mode, in the subprocess of tests/torch_reference.py)
within that rung's documented class on top of the kernel's own parity
bound, and to the port's ``'highest'`` result bit for bit.
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    fourier_inputs,
    gram_inputs,
    run_reference,
)

from pint_tpu_torch.ops import fourier  # noqa: E402
from pint_tpu_torch.ops.fused_gram import fused_gram_joint  # noqa: E402

F64 = torch.float64
RUNGS = ["highest", "high", "default"]
KERNELS = ["fused_gram_joint", "fourier_gram", "fourier_apply"]
#: (n, k, p1), (n, k, p) and (n, k, m) of the three kernels' inputs
JOINT, GRAM, APPLY = (2048, 16, 4), (500, 5, 3), (1000, 12, 4)
#: each kernel's parity bound at 'highest' (tests/test_torch_wide_gram.py)
BOUND = {"fused_gram_joint": 3e-6, "fourier_gram": 2e-6,
         "fourier_apply": 2e-6}
#: each rung's documented error class, relative to scale:
#: pint_tpu/ops/pallas_kernels.py (bf16x3 'high' ~1e-6, single-pass
#: 'default' ~1e-3) and, for fused_gram_joint's 'high',
#: tests/test_fused_interior.py::test_fused_gram_precision_high_rung (1e-3)
RUNG_CLASS = {"highest": 0.0, "high": 1e-6, "default": 1e-3}
JOINT_HIGH_CLASS = 1e-3

_SCRIPT = textwrap.dedent(f"""
import jax.numpy as jnp
import torch_reference as tr
from pint_tpu.ops.pallas_fit import fused_gram_joint
from pint_tpu.ops.pallas_kernels import fourier_apply, fourier_gram

T, A, w = tr.gram_inputs(*{JOINT!r})
t, f, fw, X = tr.fourier_inputs(*{GRAM!r})
at, af, _, _ = tr.fourier_inputs({APPLY[0]}, {APPLY[1]}, 1)
z = np.random.default_rng(9).normal(size=(2 * {APPLY[1]}, {APPLY[2]}))
for rung in {RUNGS!r}:
    G = fused_gram_joint(jnp.asarray(T, jnp.float32), jnp.asarray(A),
                         jnp.asarray(w), precision=rung)
    for i, g in enumerate(G):
        OUT[f"fused_gram_joint/{{rung}}/{{i}}"] = np.asarray(g)
    G = fourier_gram(jnp.asarray(t), jnp.asarray(f), jnp.asarray(fw),
                     jnp.asarray(X), precision=rung)
    for i, g in enumerate(G):
        OUT[f"fourier_gram/{{rung}}/{{i}}"] = np.asarray(g)
    OUT[f"fourier_apply/{{rung}}/0"] = np.asarray(fourier_apply(
        jnp.asarray(at), jnp.asarray(af), jnp.asarray(z), precision=rung))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT, tmp_path_factory.mktemp("ref") / "rungs.npz")


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _port(kernel, precision):
    """The port's result (a tuple of tensors) at ``precision`` on the CPU."""
    if kernel == "fused_gram_joint":
        T, A, w = gram_inputs(*JOINT)
        return fused_gram_joint(_t(T).float(), _t(A), _t(w),
                                precision=precision)
    if kernel == "fourier_gram":
        return fourier.fourier_gram(*(_t(x) for x in fourier_inputs(*GRAM)),
                                    precision=precision)
    t, f, _, _ = fourier_inputs(APPLY[0], APPLY[1], 1)
    z = np.random.default_rng(9).normal(size=(2 * APPLY[1], APPLY[2]))
    return (fourier.fourier_apply(_t(t), _t(f), _t(z), precision=precision),)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_rung_matches_reference_rung(ref, kernel, rung):
    """The port at each rung: within the reference's result at that rung
    (the kernel's bound plus the rung's class, of scale), and bitwise
    equal to the port at 'highest'."""
    got = _port(kernel, rung)
    top = _port(kernel, "highest")
    cls = (JOINT_HIGH_CLASS if (kernel, rung) == ("fused_gram_joint", "high")
           else RUNG_CLASS[rung])
    for i, (g, h) in enumerate(zip(got, top)):
        assert torch.equal(g, h), (kernel, rung, i)
        want = ref[f"{kernel}/{rung}/{i}"]
        assert g.shape == want.shape
        scale = np.max(np.abs(want))
        err = np.max(np.abs(g.double().numpy() - want))
        assert err <= (BOUND[kernel] + cls) * scale, (kernel, rung, i, err)
