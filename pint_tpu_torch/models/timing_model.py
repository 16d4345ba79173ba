"""TimingModel: ordered component composition -> compiled tensor kernels.

Counterpart of ``pint_tpu/models/timing_model.py``.  A TimingModel is an
ordered bag of components (delays folded in category order, each seeing
the accumulated delay; phase components summed at the delayed time).
``compile(toas, device)`` freezes it against a TOA table: mask parameters
become static 0/1 columns, a TZR anchor (AbsPhase) brings its one-row
bundle along, and the result is a :class:`CompiledModel`
whose kernels are pure functions of ``x`` — the f64 vector of deltas of
the free parameters from their reference values (internal units).  x = 0
reproduces the reference model; ``commit(x)`` folds deltas back into the
host parameters.  The design matrix is ``torch.func.jacfwd`` of the
phase-residual kernel over the spin frequency.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd

from pint_tpu_torch.device import F64, resolve_device
from pint_tpu_torch.exceptions import TimingModelError
from pint_tpu_torch.models.component import (
    DEFAULT_ORDER,
    Component,
    DelayComponent,
    NoiseComponent,
    PhaseComponent,
)
from pint_tpu_torch.models.parameter import MJDParameter, Parameter
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.ops.phase import Phase
from pint_tpu_torch.runtime.graphs import ProgramCache, flatten
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.bundle import TOABundle, as_table, make_bundle


class TimingModel:
    """Host-side model: components + top-level metadata parameters."""

    def __init__(self, components=(), name: str = ""):
        self.name = name
        self.components: dict[str, Component] = {}
        self.top_params: dict[str, Parameter] = {}
        # par lines no component accepted (models/builder.py::get_model)
        self.unrecognized: dict = {}
        for c in components:
            self.add_component(c, setup=False)
        self.setup()

    def add_component(self, comp: Component, setup: bool = True):
        name = type(comp).__name__
        if name in self.components:
            raise TimingModelError(f"duplicate component {name}")
        self.components[name] = comp
        if setup:
            self.setup()

    def remove_component(self, name: str):
        self.components.pop(name)

    def setup(self):
        for c in self._ordered_components():
            c.setup(self)

    def validate(self):
        for c in self._ordered_components():
            c.validate(self)

    def _ordered_components(self) -> list[Component]:
        def key(c):
            try:
                return DEFAULT_ORDER.index(c.category)
            except ValueError:
                return len(DEFAULT_ORDER)

        return sorted(self.components.values(), key=key)

    @property
    def delay_components(self) -> list[DelayComponent]:
        return [c for c in self._ordered_components()
                if isinstance(c, DelayComponent)]

    @property
    def phase_components(self) -> list[PhaseComponent]:
        return [c for c in self._ordered_components()
                if isinstance(c, PhaseComponent)]

    @property
    def noise_components(self) -> list[NoiseComponent]:
        return [c for c in self._ordered_components()
                if isinstance(c, NoiseComponent)]

    @property
    def params(self) -> dict[str, Parameter]:
        out = dict(self.top_params)
        for c in self._ordered_components():
            out.update(c.params)
        return out

    def __getattr__(self, name):
        d = object.__getattribute__(self, "__dict__")
        for c in d.get("components", {}).values():
            if name in c.params:
                return c.params[name]
        if name in d.get("top_params", {}):
            return d["top_params"][name]
        raise AttributeError(f"TimingModel has no parameter {name!r}")

    def __getitem__(self, name):
        p = self.params.get(name)
        if p is None:
            raise KeyError(name)
        return p

    @property
    def free_params(self) -> list[str]:
        out = []
        for c in self._ordered_components():
            out.extend(c.free_params)
        return out

    @property
    def fittable_params(self) -> list[str]:
        """Continuous set parameters (epochs included: they fit through
        a seconds delta, ``CompiledModel._pdict`` and ``commit``)."""
        out = []
        for c in self._ordered_components():
            for n, p in c.params.items():
                if p.continuous and p.value is not None:
                    out.append(n)
        return out

    def free_params_component(self) -> list[tuple[str, Component]]:
        out = []
        for c in self._ordered_components():
            out.extend((n, c) for n in c.free_params)
        return out

    def _build_masks(self, toas, noise: bool = True) -> dict:
        """Mask selections and noise bases: taken from the table's
        precomputed ``masks`` when present (byte-identical state carried
        across from the JAX package), else computed on the host.
        ``noise=False`` leaves the noise components out (a TZR row needs
        only what the delays and phases read)."""
        given = toas.get("masks") or {}
        masks = {}
        for c in self._ordered_components():
            if not noise and isinstance(c, NoiseComponent):
                continue
            for n in c.mask_params:
                masks[n] = (
                    given[n] if n in given
                    else c.params[n].select(toas).astype(np.float64)
                )
            if hasattr(c, "extra_masks"):
                keys = c.basis_keys()
                masks.update(
                    {k: given[k] for k in keys}
                    if all(k in given for k in keys) else c.extra_masks(toas)
                )
        return masks

    @property
    def tzr_anchor(self):
        """The AbsPhase component when it sets TZRMJD, else None."""
        absph = self.components.get("AbsPhase")
        return absph if absph is not None and absph.anchored else None

    def has_tzr_anchor(self) -> bool:
        """True when the model carries an AbsPhase TZR anchor."""
        return self.tzr_anchor is not None

    def make_bundle(self, toas, device) -> TOABundle:
        """Host TOA table or TOAs -> device bundle with this model's
        masks, and with its TZR row: the table's ``"tzr"`` row when it
        carries one, else ``AbsPhase.tzr_table``'s (the TZR arrival
        ingested through this model's chain)."""
        toas = as_table(toas)
        bundle = make_bundle(toas, self._build_masks(toas), device)
        return self._with_tzr(bundle, toas.get("tzr"))

    def _with_tzr(self, bundle: TOABundle, tzr_table=None) -> TOABundle:
        anchor = self.tzr_anchor
        if anchor is None:
            return bundle._replace(tzr=None)
        if tzr_table is None:
            if bundle.tzr is not None:
                return bundle
            tzr_table = anchor.tzr_table(self)
        tzr = make_bundle(tzr_table, self._build_masks(tzr_table,
                                                       noise=False),
                          bundle.device)
        return bundle._replace(tzr=tzr)

    def compile(self, toas, device=None,
                subtract_mean: bool = True) -> "CompiledModel":
        """Freeze against a host TOA table or TOAs, or against a
        TOABundle that is already on a device (``device`` must then
        agree with it)."""
        if isinstance(toas, TOABundle):
            if device is not None and torch.device(device) != toas.device:
                raise ValueError(
                    f"bundle is on {toas.device}, device={device!r} asked"
                )
            bundle = self._with_tzr(toas)
        else:
            bundle = self.make_bundle(toas, resolve_device(device))
        return CompiledModel(self, bundle, subtract_mean=subtract_mean)

    def as_parfile(self) -> str:
        """The model as par text: top-level lines, then every
        component's parameters in evaluation order (reference:
        ``TimingModel.as_parfile``), with a BINARY line for the binary
        model so that the text reads back to the same model."""
        lines = [p.as_parfile_line() for n, p in self.top_params.items()
                 if n != "BINARY"]  # written from the binary component
        lines += [f"{'BINARY':<15} {c.binary_model_name:>25}\n"
                  for c in self.components.values()
                  if getattr(c, "binary_model_name", "")]
        for c in self._ordered_components():
            lines += [p.as_parfile_line() for p in c.params.values()]
        return "".join(lines)

    # -- one-shot evaluations that compile on ``device`` (None: the CUDA
    # card); fitters hold a CompiledModel instead of calling these -------
    def delay(self, toas, device=None) -> np.ndarray:
        """Total delay (s) at each TOA for the current parameters."""
        cm = self.compile(toas, device=device)
        return cm.delay(cm.x0()).cpu().numpy()

    def phase(self, toas, device=None):
        """(int_cycles, frac) model phase arrays at each TOA."""
        cm = self.compile(toas, device=device, subtract_mean=False)
        ph = cm.phase(cm.x0())
        return ph.int_.cpu().numpy(), ph.frac.cpu().numpy()

    def designmatrix(self, toas, device=None):
        """(M (n, p) seconds per internal unit, free-parameter names)."""
        cm = self.compile(toas, device=device)
        return cm.design_matrix(cm.x0()).cpu().numpy(), list(cm.free_names)

    def d_phase_d_param(self, toas, param: str, device=None) -> np.ndarray:
        """Phase derivative (cycles per internal unit) for one free
        parameter: one forward-mode product with a unit tangent, not a
        full Jacobian."""
        cm = self.compile(toas, device=device)
        if param not in cm.free_names:
            raise TimingModelError(
                f"{param} is not a free parameter of this model")
        x = cm.x0()
        tangent = torch.zeros_like(x)
        tangent[cm.free_names.index(param)] = 1.0
        _, col = torch.func.jvp(cm.phase_residuals, (x,), (tangent,))
        return col.cpu().numpy()

    def clone(self) -> "TimingModel":
        """An independent copy that shares nothing mutable with this
        model: fresh component instances with deep-copied Parameters and
        every other instance attribute deep-copied too (the registries
        the builder fills outside ``params``, such as
        ``DispersionDMX.dmx_indices`` and ``EcorrNoise``'s and
        ``PhaseJump``'s mask families, which a clone that dropped them
        would silently lose from the noise basis or the design matrix),
        deep-copied top-level parameters, then ``setup()``.  The ingested
        TZR arrival memoized on AbsPhase (``_tzr_memo``) is not copied:
        a later compile of the clone ingests it anew."""
        comps = []
        for c in self.components.values():  # in this model's order
            c2 = type(c)()
            for k, v in vars(c).items():
                if k in ("params", "_tzr_memo"):
                    continue
                setattr(c2, k, copy.deepcopy(v))
            c2.params = {n: copy.deepcopy(p) for n, p in c.params.items()}
            comps.append(c2)
        m = TimingModel(comps, name=self.name)
        m.top_params = copy.deepcopy(self.top_params)
        m.unrecognized = copy.deepcopy(self.unrecognized)
        m.setup()
        return m

    def _compare_view(self) -> dict:
        """name -> repr of the value (None when unset) in the reference's
        order and spelling: its fixed top-level parameters first (the
        BINARY line among them), then every component's parameters in
        evaluation order."""
        out = {}
        for name, aliases in _TOP_ORDER:
            p = next((self.top_params[k] for k in (name, *aliases)
                      if k in self.top_params), None)
            if name == "BINARY":
                v = next((c.binary_model_name
                          for c in self.components.values()
                          if getattr(c, "binary_model_name", "")), None)
                out[name] = None if v is None else repr(v)
            elif name == "DMDATA" and p is not None:
                out[name] = repr(float(p.value))  # a float there
            else:
                out[name] = None if p is None else _value_repr(p)
        for c in self._ordered_components():
            for n, p in c.params.items():
                out[n] = _value_repr(p)
        return out

    def compare(self, other: "TimingModel") -> str:
        """Human-readable parameter comparison (reference:
        ``TimingModel.compare``): one row a parameter set in either
        model, '*' where the values differ."""
        mine, theirs = self._compare_view(), other._compare_view()
        rows = []
        for n in list(mine) + [n for n in theirs if n not in mine]:
            a, b = mine.get(n), theirs.get(n)
            if a is None and b is None:
                continue
            a, b = a or "None", b or "None"
            mark = "" if a == b else "  *"
            rows.append(f"{n:<12} {a:>25} {b:>25}{mark}")
        return "\n".join(rows)

    def __repr__(self):
        return f"TimingModel({self.name}, [{', '.join(self.components)}])"


#: the reference's top-level parameters in its order, with their aliases
_TOP_ORDER = (
    ("PSR", ("PSRJ", "PSRB")), ("EPHEM", ()), ("CLOCK", ("CLK",)),
    ("UNITS", ()), ("TIMEEPH", ()), ("T2CMETHOD", ()), ("DILATEFREQ", ()),
    ("START", ()), ("FINISH", ()), ("NTOA", ()), ("TRES", ()),
    ("INFO", ()), ("BINARY", ()), ("CHI2", ()), ("CHI2R", ()),
    ("DMDATA", ()),
)


def _value_repr(p: Parameter):
    """repr of a parameter's value as the reference holds it (None when
    unset): the value as given, an epoch as a one-element TimeArray."""
    v = p._par_value()
    if v is None:
        return None
    if isinstance(p, MJDParameter):
        day, sec = p.internal()
        v = TimeArray(np.array([day], dtype=np.int64),
                      HostDD(np.array([sec.hi]), np.array([sec.lo])),
                      p.time_scale)
    return repr(v)


def reference_values(model: TimingModel) -> dict:
    """Reference (internal-unit) values of every set parameter: the x = 0
    anchor of a CompiledModel's delta vector."""
    ref: dict[str, object] = {}
    for c in model._ordered_components():
        for n, p in c.params.items():
            if p.value is None:
                continue
            ref[n] = p.internal()
    return ref


def _scalar(v: float, device) -> torch.Tensor:
    # a fill kernel: never a host-to-device copy, which would wait for the
    # card's queue on every kernel call
    return torch.full((), float(v), dtype=F64, device=device)


def split_ref(ref: dict, device):
    """Reference values -> (numeric, static): floats as f64 device
    scalars, HostDD as DD, epochs as (day, DD seconds) with the exact day
    a device scalar too; bools, strings and pair parameters' float pairs
    stay static host values.  The numeric part is what a PTA batch
    stacks, one entry a pulsar (``parallel/pta.py``)."""
    num, static = {}, {}
    for n, v in ref.items():
        if isinstance(v, HostDD):
            num[n] = DD(_scalar(v.hi, device), _scalar(v.lo, device))
        elif isinstance(v, tuple) and len(v) == 2 and isinstance(
            v[1], HostDD
        ):
            day, sec = v
            num[n] = (_scalar(day, device),
                      DD(_scalar(sec.hi, device), _scalar(sec.lo, device)))
        elif isinstance(v, (float, int)) and not isinstance(v, bool):
            num[n] = _scalar(v, device)
        else:
            static[n] = v
    return num, static


def device_anchors(model: TimingModel, device) -> dict:
    """The host values that components take their kernels about (the
    astrometry's reference angles with their host sine and cosine,
    ``Component.anchors``) as device scalars, keyed as the components
    read them from the parameter dict."""
    out = {}
    for c in model._ordered_components():
        for key, vals in c.anchors().items():
            out[key] = tuple(_scalar(v, device) for v in vals)
    return out


class CompiledModel:
    """A TimingModel frozen against a TOA bundle: pure kernels of x.

    x layout: one f64 entry per free parameter, in ``free_names`` order,
    holding the delta from the reference value in internal units."""

    def __init__(self, model: TimingModel, bundle: TOABundle,
                 subtract_mean=True):
        self.model = model
        self.bundle = bundle
        self.device = bundle.device
        self.subtract_mean = subtract_mean
        self.free_names = model.free_params
        self._index = {n: i for i, n in enumerate(self.free_names)}
        self.ref: dict[str, object] = reference_values(model)
        # device copy of ref (built at the first kernel call): every
        # numeric reference scalar and anchor a 0-d view of ONE buffer,
        # which commit() rewrites in place
        self._ref_dev = None
        # the fit loops' step programs (runtime/graphs.py); their graphs
        # read the reference buffer by address, so they survive commit()
        self.programs = ProgramCache(self.device)
        self.track_mode = (
            "use_pulse_numbers"
            if not bool(torch.all(torch.isnan(bundle.pulse_number)))
            else "nearest"
        )

    @property
    def nfree(self) -> int:
        return len(self.free_names)

    def x0(self) -> torch.Tensor:
        return torch.zeros(self.nfree, dtype=F64, device=self.device)

    def _pdict(self, x):
        """Parameter values at x: the cached device references plus the
        deltas of the free parameters (normalized for DD values).  The
        f64 ones are added as one vector (three operators, where a model
        with 150 DMX ranges would take 300 a call), each value the same
        f64 sum as a scalar add."""
        if self._ref_dev is None:
            self._build_refs()
        pd = dict(self._ref_dev)
        if self._flat_names:
            vals = (self._flat_ref + x[self._flat_index]).unbind(0)
            pd.update(zip(self._flat_names, vals))
        for n, i in self._index.items():
            v = pd[n]
            if isinstance(v, DD):
                pd[n] = (v + x[i]).normalize()
            elif isinstance(v, tuple):
                day, sec = v  # epoch: x[i] is a seconds delta
                pd[n] = (day, (sec + x[i]).normalize())
        return pd

    # -- kernels ----------------------------------------------------------
    def delay(self, x):
        """Total delay in seconds (f64) at each TOA."""
        pd = self._pdict(x)
        d = torch.zeros(self.bundle.ntoa, dtype=F64, device=self.device)
        for c in self.model.delay_components:
            d = d + c.delay_term(pd, self.bundle, d)
        return d

    def phase(self, x, bundle: Optional[TOABundle] = None) -> Phase:
        """Model phase at each row of ``bundle`` (the data by default)."""
        b = self.bundle if bundle is None else bundle
        pd = self._pdict(x)
        d = torch.zeros(b.ntoa, dtype=F64, device=self.device)
        for c in self.model.delay_components:
            d = d + c.delay_term(pd, b, d)
        total = DD.zeros(b.ntoa, self.device)
        for c in self.model.phase_components:
            total = total + c.phase_term(pd, b, d)
        return Phase.from_dd(total)

    def absolute_phase(self, x) -> Phase:
        """The data's model phase minus the TZR row's when the model has
        an AbsPhase anchor (carry-normalized ``Phase.__sub__``), else the
        raw model phase.  The TZR phase is evaluated here, at x, so it is
        inside every derivative and batched evaluation of x."""
        ph = self.phase(x)
        if self.bundle.tzr is not None:
            ph = ph - self.phase(x, bundle=self.bundle.tzr)[0]
        return ph

    def spin_frequency(self, x):
        """Instantaneous spin frequency at each TOA."""
        pd = self._pdict(x)
        for c in self.model.phase_components:
            if hasattr(c, "spin_frequency"):
                return c.spin_frequency(pd, self.bundle)
        raise TimingModelError("no spindown component in model")

    def phase_residuals(self, x):
        """Phase residuals in cycles (f64), no mean subtraction, from the
        TZR-anchored phase."""
        ph = self.absolute_phase(x)
        if self.track_mode == "use_pulse_numbers":
            b = self.bundle
            return (ph.int_ - b.pulse_number + b.padd) + ph.frac
        return ph.frac

    # -- wideband DM measurements -----------------------------------------
    def dm_model(self, x):
        """Model DM at each TOA (pc cm^-3): every delay component's
        ``dm_value`` (DM, DMX, the solar wind) and ``dm_offset`` (the
        DMJUMPs' shift to the measurement scale), in component order."""
        pd = self._pdict(x)
        dm = torch.zeros(self.bundle.ntoa, dtype=F64, device=self.device)
        for c in self.model.delay_components:
            if hasattr(c, "dm_value"):
                dm = dm + c.dm_value(pd, self.bundle)
            if hasattr(c, "dm_offset"):
                dm = dm + c.dm_offset(pd, self.bundle)
        return dm

    def _dm_measurements(self):
        b = self.bundle
        if b.dm_meas is None:
            raise TimingModelError(
                "no wideband DM measurements (-pp_dm flags) in these TOAs"
            )
        return b.dm_meas, b.dm_err

    def dm_residuals(self, x):
        """Wideband DM residuals, measured minus model (pc cm^-3)."""
        return self._dm_measurements()[0] - self.dm_model(x)

    def scaled_dm_sigma(self, x):
        """Per-TOA DM-measurement uncertainty (pc cm^-3) after the
        DMEFAC/DMEQUAD rescaling."""
        sig = self._dm_measurements()[1]
        pd = self._pdict(x)
        for c in self.model.noise_components:
            if hasattr(c, "scaled_dm_sigma"):
                sig = c.scaled_dm_sigma(pd, self.bundle, sig)
        return sig

    def scaled_sigma(self, x):
        """Per-TOA white uncertainty in seconds after noise rescaling."""
        pd = self._pdict(x)
        sig = self.bundle.error_us * 1e-6
        for c in self.model.noise_components:
            sig = c.scaled_sigma(pd, self.bundle, sig)
        return sig

    def noise_basis(self, x):
        """Stacked correlated-noise basis/weights (T (n, k), phi (k,)),
        or None."""
        pd = self._pdict(x)
        bases, weights = [], []
        for c in self.model.noise_components:
            bw = c.basis_weight(pd, self.bundle)
            if bw is not None:
                bases.append(bw[0])
                weights.append(bw[1])
        if not bases:
            return None
        return torch.cat(bases, dim=1), torch.cat(weights)

    def noise_basis_or_empty(self, x):
        """Like noise_basis but never None: models without correlated
        noise get one zero basis column with weight 1e-30 (the column is
        zero, so any finite weight is exact and 1/phi stays finite)."""
        bw = self.noise_basis(x)
        if bw is not None:
            return bw
        n = self.bundle.ntoa
        return (
            torch.zeros((n, 1), dtype=F64, device=self.device),
            torch.ones(1, dtype=F64, device=self.device) * 1e-30,
        )

    def noise_covariance(self, x):
        """Dense (n, n) noise covariance C = diag(N) + T phi T^T
        (``models/noise.py::dense_noise_cov``): O(n^2) memory, for
        diagnostics and small n."""
        from pint_tpu_torch.models.noise import dense_noise_cov

        Ndiag = torch.square(self.scaled_sigma(x))
        bw = self.noise_basis(x)
        T, phi = bw if bw is not None else (None, None)
        return dense_noise_cov(Ndiag, T, phi)

    def noise_fourier_spec(self, x):
        """(t_seconds, freqs, phi) when the model's correlated noise is
        exactly one pure-Fourier basis (power-law red noise), the shape
        the streaming-basis GLS step takes; None otherwise."""
        pd = self._pdict(x)
        specs = [c.fourier_spec(pd, self.bundle)
                 for c in self.model.noise_components
                 if hasattr(c, "fourier_spec")]
        n_corr = sum(c.introduces_correlated_errors
                     for c in self.model.noise_components)
        if len(specs) == 1 and n_corr == 1:
            return specs[0]
        return None

    @property
    def has_correlated_errors(self) -> bool:
        return any(c.introduces_correlated_errors
                   for c in self.model.noise_components)

    def _weights(self, x):
        return 1.0 / torch.square(self.scaled_sigma(x))

    def time_residuals(self, x, subtract_mean: Optional[bool] = None):
        """Time residuals in seconds; weighted-mean-subtracted by default."""
        sm = self.subtract_mean if subtract_mean is None else subtract_mean
        r = self.phase_residuals(x) / self.spin_frequency(x)
        if sm:
            w = self._weights(x)
            r = r - torch.sum(w * r) / torch.sum(w)
        return r

    def chi2(self, x):
        """White chi2: the weighted sum of squares of the (by default
        weighted-mean-subtracted) time residuals."""
        r = self.time_residuals(x)
        return torch.sum(self._weights(x) * r * r)

    def design_matrix(self, x):
        """(n_toa, n_free) d(time-resid)/d(param delta), seconds per
        internal unit: jacfwd of the phase residual over the spin
        frequency."""
        jac = jacfwd(self.phase_residuals)(x)
        return jac / self.spin_frequency(x)[:, None]

    def program(self, fn, key):
        """``fn`` of static-shape tensors as a step program, cached under
        ``key`` (across ``commit``): CUDA graphs replayed on the card,
        ``fn`` itself on the CPU, behind the device-execution guard
        (``runtime/graphs.py::ProgramCache``).  The counterpart of the
        reference's ``CompiledModel.jit``, the chokepoint through which
        its fit loops become one device program."""
        return self.programs.program(fn, key)

    # -- device references ------------------------------------------------
    def _host_refs(self):
        """The device references as host values: (numeric + anchor tree
        of 0-d CPU tensors, static values, the components' host reads)."""
        num, static = split_ref(self.ref, "cpu")
        anchors = device_anchors(self.model, "cpu")
        host_reads = [(n, c.host_state())
                      for n, c in self.model.components.items()]
        return (num, anchors), static, host_reads

    def _build_refs(self):
        """Build the device references: every numeric reference scalar
        and anchor a 0-d view of one f64 buffer (one host-to-device
        copy), the static values as they are, and the f64 references of
        the free parameters as one vector (``_flat_ref``)."""
        tree, static, host_reads = self._host_refs()
        leaves, rebuild = flatten(tree)
        self._ref_buf = (torch.stack(leaves) if leaves
                         else torch.zeros(0, dtype=F64)).to(self.device)
        num, anchors = rebuild(list(self._ref_buf.unbind(0)))
        self._ref_sig = (len(leaves), static, host_reads)
        self._ref_dev = {**static, **num, **anchors}
        flat = [(n, i) for n, i in self._index.items()
                if not isinstance(self.ref[n], (HostDD, tuple))]
        self._flat_names = [n for n, _ in flat]
        self._flat_index = torch.tensor([i for _, i in flat],
                                        dtype=torch.long,
                                        device=self.device)
        self._flat_ref = torch.tensor(
            [float(self.ref[n]) for n in self._flat_names], dtype=F64,
            device=self.device)

    def _rebase(self):
        """After a commit: write the new reference values in place into
        the tensors the step programs' graphs read (``_ref_buf``,
        ``_flat_ref``), the counterpart of the reference feeding its
        references to its programs as runtime arguments.  What a step
        takes as a Python value at capture — the static references
        (bools, strings, pair parameters), the components'
        ``host_state`` (which glitches decay, the IFUNC table) — is
        structural: when a commit changes it (or the number of device
        references), the references are rebuilt and the programs
        dropped, as a change of the free set or of the components does
        (a new CompiledModel)."""
        if self._ref_dev is None:
            return
        tree, static, host_reads = self._host_refs()
        leaves, _ = flatten(tree)
        if (len(leaves), static, host_reads) != self._ref_sig:
            self._ref_dev = None
            self.programs.clear()
            return
        if leaves:
            self._ref_buf.copy_(torch.stack(leaves))
        self._flat_ref.copy_(torch.tensor(
            [float(self.ref[n]) for n in self._flat_names], dtype=F64))

    # -- commit fitted deltas back to host parameters ---------------------
    def commit(self, x, uncertainties=None):
        x = np.asarray(x, dtype=np.float64)
        params = self.model.params
        for n, i in self._index.items():
            p = params[n]
            ref = self.ref[n]
            if isinstance(p, MJDParameter):
                p.add_internal_delta(float(x[i]))
            elif isinstance(ref, HostDD):
                p.set_internal(ref + float(x[i]))
            else:
                p.set_internal(float(ref) + float(x[i]))
            if uncertainties is not None:
                p.set_internal_uncertainty(float(uncertainties[i]))
        for n in self._index:
            self.ref[n] = params[n].internal()
        self._rebase()
