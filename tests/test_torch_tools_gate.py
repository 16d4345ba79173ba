"""The tools' gate on the CPU: in a subprocess where ``import jax`` and
``import pint_tpu`` raise, zima writes a tim file and ``pintempo`` fits
it back to the truth; ``photonphase`` phases pulsed events (H-test above
200); polycos agree with the model's phase within 1e-6 cycles; and
``event_optimize`` recovers F0 within 3e-5 (the reference test's gate).
Nothing of JAX or of the JAX package is imported on the way.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import REPO  # noqa: E402

GATE_SCRIPT = r"""
import importlib.abc, json, sys, tempfile, warnings, contextlib, io
from pathlib import Path

class Bar(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "pint_tpu" \
                or name.startswith("pint_tpu."):
            raise ImportError(f"{name} is barred")
        return None

sys.meta_path.insert(0, Bar())
sys.path.insert(0, REPO)
warnings.simplefilter("ignore")
import numpy as np
from pint_tpu_torch.event_toas import load_event_TOAs
from pint_tpu_torch.io.fits import write_event_fits
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.polycos import Polycos
from pint_tpu_torch.scripts import event_optimize, photonphase, pintempo, zima
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.ingest import ingest_barycentric
from pint_tpu_torch.toas.toas import TOAs

PAR = ("PSR J1744-1134\nF0 245.4261196898081 1\nF1 -5.38e-16 1\n"
       "PEPOCH 55000\nDM 3.1380 1\n")
CPU = ["--device", "cpu", "--log-level", "ERROR"]
out = {}
tmp = Path(tempfile.mkdtemp())
(tmp / "p.par").write_text(PAR)
with contextlib.redirect_stdout(io.StringIO()):
    assert zima.main([str(tmp / "p.par"), str(tmp / "p.tim"), "--ntoa",
                      "60", "--startMJD", "55000", "--duration", "500",
                      "--addnoise", "--seed", "3"] + CPU) == 0
    assert pintempo.main([str(tmp / "p.par"), str(tmp / "p.tim"),
                          "--outfile", str(tmp / "fit.par")] + CPU) == 0
out["pintempo_f0"] = float(get_model(str(tmp / "fit.par"))
                           .params["F0"].value.to_float())

m = get_model(PAR)
rng = np.random.default_rng(7)
met = np.sort(rng.uniform(0, 2000.0, 6000))
hdr = {"MJDREFI": 55000, "MJDREFF": 0.0, "TIMEZERO": 0.0, "TIMESYS": "TDB"}
write_event_fits(str(tmp / "ev.fits"), {"TIME": met}, header_extra=hdr)
toas = load_event_TOAs(str(tmp / "ev.fits"))
ingest_barycentric(toas)
cm = m.compile(toas, device="cpu", subtract_mean=False)
ph = np.mod(cm.phase(cm.x0()).frac.numpy(), 1.0)
keep = (rng.uniform(size=len(ph))
        < 0.1 + np.exp(-0.5 * ((ph - 0.5) / 0.05) ** 2))
write_event_fits(str(tmp / "ev.fits"), {"TIME": met[keep]},
                 header_extra=hdr)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert photonphase.main([str(tmp / "ev.fits"), str(tmp / "p.par"),
                             "--outfile", str(tmp / "ph.fits")] + CPU) == 0
out["htest"] = float(buf.getvalue().split("Htest :")[1].split()[0])

pcs = Polycos.generate(m, 55000.0, 55000.25, obs="@", ncoeff=12,
                       device="cpu")
mjds = 55000.0 + np.sort(rng.uniform(0.01, 0.24, 50))
pt = TOAs(TimeArray.from_mjd_float(mjds, scale="utc"), np.full(50, 1400.0),
          np.ones(50), ["@"] * 50, [dict() for _ in range(50)])
ingest_barycentric(pt)
pcm = m.compile(pt, device="cpu", subtract_mean=False)
mp = pcm.phase(pcm.x0())
ints, fracs = pcs.eval_abs_phase(mjds)
out["polyco_gap"] = float(np.max(np.abs(
    (ints - mp.int_.numpy()) + (fracs - mp.frac.numpy()))))

(tmp / "fit0.par").write_text(
    "PSR J1744-1134\nF0 245.42621968980 1\nPEPOCH 55000\nDM 3.138\n")
(tmp / "t.gauss").write_text(
    "const = 0.5\nphas1 = 0.5\nfwhm1 = 0.117741\nampl1 = 0.5\n")
with contextlib.redirect_stdout(io.StringIO()):
    assert event_optimize.main([
        str(tmp / "ev.fits"), str(tmp / "fit0.par"), str(tmp / "t.gauss"),
        "--nsteps", "400", "--nwalkers", "16", "--seed", "1",
        "--outfile", str(tmp / "post.par")] + CPU) == 0
out["event_optimize_f0"] = float(get_model(str(tmp / "post.par"))
                                 .params["F0"].value.to_float())
out["barred"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "pint_tpu"))
print(json.dumps(out))
"""


def test_tools_gate_without_jax_or_reference():
    code = f"REPO = {str(REPO)!r}\n" + textwrap.dedent(GATE_SCRIPT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-6000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["barred"] == []
    assert abs(out["pintempo_f0"] - 245.4261196898081) < 1e-9
    assert out["htest"] > 200.0
    assert out["polyco_gap"] < 1e-6
    assert abs(out["event_optimize_f0"] - 245.4261196898081) < 3e-5
