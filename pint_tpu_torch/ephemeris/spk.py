"""SPK/DAF binary ephemeris kernels: reader, writer, evaluator.

Counterpart of ``pint_tpu/ephemeris/spk.py`` (the jplephem capability
PINT uses in solar_system_ephemerides.py::objPosVel_wrt_SSB): a host-side
segment loader plus batched numpy Chebyshev evaluation of many epochs at
once.

Format: NAIF DAF ("double precision array file", 1024-byte records);
SPK segments of data type 2 (position Chebyshev, velocity by
differentiation) and type 3 (position+velocity Chebyshev) — the types
used by every DExxx planetary ephemeris.  The writer emits valid
single-file type-2 kernels, used for round-trip tests and for caching
device-ready ephemeris products.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from pint_tpu_torch.exceptions import (
    EphemerisFormatError,
    EphemerisSegmentError,
)

RECLEN = 1024
J2000_JD = 2451545.0
S_PER_DAY = 86400.0


class Segment(NamedTuple):
    target: int
    center: int
    frame: int
    data_type: int
    start_et: float
    stop_et: float
    # type 2/3 payload
    init: float
    intlen: float
    rsize: int
    n_records: int
    # (n_records, ncomp, ncoef) Chebyshev coefficients + per-record mid/radius
    coeffs: np.ndarray
    mid: np.ndarray
    radius: np.ndarray

    @property
    def ncomp(self):
        return self.coeffs.shape[1]


class SPK:
    """A loaded SPK kernel: dict of (target, center) -> list[Segment]."""

    def __init__(self, segments: list[Segment], name: str = ""):
        self.name = name
        self.pairs: dict[tuple[int, int], list[Segment]] = {}
        for s in segments:
            self.pairs.setdefault((s.target, s.center), []).append(s)
        # target -> [(body, center), ...] hops to the SSB, resolved once
        # per kernel (a per-chunk cost under the chunked ingest of
        # toas/ingest_topo.py otherwise)
        self._ssb_chains: dict[int, list[tuple[int, int]]] = {}

    # -- loading ----------------------------------------------------------
    @classmethod
    def open(cls, path) -> "SPK":
        with open(path, "rb") as f:
            data = f.read()
        if data[:8] not in (b"DAF/SPK ", b"NAIF/DAF"):
            raise EphemerisFormatError(f"{path}: not a DAF/SPK file ({data[:8]!r})")
        try:
            return cls._parse(data, path)
        except EphemerisFormatError:
            raise
        except (ValueError, struct.error, IndexError) as e:
            # truncated/corrupt files surface as bare numpy/struct
            # errors (frombuffer size, short unpack) — classify them
            # so env-sensitive consumers can tell data problems from
            # code bugs
            raise EphemerisFormatError(
                f"{path}: truncated or malformed DAF/SPK ({e})"
            ) from e

    @classmethod
    def _parse(cls, data, path) -> "SPK":
        locfmt = data[88:96]
        if locfmt.startswith(b"BIG-IEEE"):
            endian = ">"
        elif locfmt.startswith(b"LTL-IEEE"):
            endian = "<"
        else:
            raise EphemerisFormatError(f"unsupported DAF binary format {locfmt!r}")
        nd, ni = struct.unpack(endian + "ii", data[8:16])
        fward, bward, free = struct.unpack(endian + "iii", data[76:88])
        if (nd, ni) != (2, 6):
            raise EphemerisFormatError(f"not an SPK summary format: ND={nd} NI={ni}")
        words = np.frombuffer(data, dtype=endian + "f8")
        ss = nd + (ni + 1) // 2  # summary size in doubles
        segments = []
        rec = fward
        while rec > 0:
            base = (rec - 1) * (RECLEN // 8)
            nxt, _prev, nsum = words[base:base + 3]
            for k in range(int(nsum)):
                s0 = base + 3 + k * ss
                start_et, stop_et = words[s0], words[s0 + 1]
                ints = np.frombuffer(
                    words[s0 + 2:s0 + 5].tobytes(), dtype=endian + "i4"
                )
                target, center, frame, dtype_, ia, ib = (int(v) for v in ints)
                if dtype_ not in (2, 3):
                    continue  # other types: skip (not used by DExxx)
                seg_words = words[ia - 1:ib]
                init, intlen, rsize, n = seg_words[-4:]
                rsize, n = int(rsize), int(n)
                if target >= 1000000000:
                    # DE-t time-ephemeris convention (TDB-TT seconds):
                    # 1-component Chebyshev records
                    ncomp = 1
                else:
                    ncomp = 3 if dtype_ == 2 else 6
                ncoef = (rsize - 2) // ncomp
                recs = seg_words[: rsize * n].reshape(n, rsize)
                mid, radius = recs[:, 0].copy(), recs[:, 1].copy()
                coeffs = recs[:, 2:].reshape(n, ncomp, ncoef).copy()
                segments.append(Segment(
                    target, center, frame, dtype_, float(start_et),
                    float(stop_et), float(init), float(intlen), rsize, n,
                    coeffs, mid, radius,
                ))
            rec = int(nxt)
        return cls(segments, name=str(path))

    # -- evaluation -------------------------------------------------------
    def _eval_pair(self, segs: list[Segment], et: np.ndarray):
        """Evaluate a (target, center) pair: kernels like de441 split
        coverage into several time segments, so epochs are routed to the
        segment that covers them."""
        if len(segs) == 1:
            return _eval_type23(segs[0], et)
        et1 = np.atleast_1d(et)
        nc = min(segs[0].ncomp, 3)
        pos = np.empty((*et1.shape, nc))
        vel = np.empty_like(pos)
        done = np.zeros(et1.shape, dtype=bool)
        for seg in segs:
            sel = (
                ~done & (et1 >= seg.start_et - 1.0)
                & (et1 <= seg.stop_et + 1.0)
            )
            if np.any(sel):
                pos[sel], vel[sel] = _eval_type23(seg, et1[sel])
                done |= sel
        if not done.all():
            spans = [(s.start_et, s.stop_et) for s in segs]
            raise EphemerisFormatError(
                f"{int((~done).sum())} epochs outside all SPK segments "
                f"for target {segs[0].target}: spans {spans}"
            )
        if np.ndim(et) == 0:
            return pos[0], vel[0]
        return pos, vel

    def pair_posvel(self, target, center, et):
        """Position (km) and velocity (km/s) of target wrt center at ET
        seconds past J2000 (TDB).  et: scalar or (n,)."""
        segs = self.pairs.get((target, center))
        if not segs:
            raise EphemerisSegmentError(
                f"no segment {target}<-{center} in {self.name}; "
                f"available: {sorted(self.pairs)}"
            )
        return self._eval_pair(segs, np.asarray(et, dtype=np.float64))

    def ssb_chain(self, target: int) -> list[tuple[int, int]]:
        """The (body, center) hops from ``target`` to the SSB, resolved
        once per kernel and memoized (called by ssb_posvel on every
        evaluation; prewarmed by ingest's IngestPlan so chunk workers
        share the routed chain)."""
        chain = self._ssb_chains.get(target)
        if chain is not None:
            return chain
        chain = []
        body = target
        while body != 0:
            # prefer the pair whose center leads toward the SSB directly
            centers = sorted(
                c for (t, c) in self.pairs if t == body
            )
            if not centers:
                raise EphemerisSegmentError(f"no segment path {target} -> SSB")
            center = centers[0]  # 0 first, then inner barycenters
            chain.append((body, center))
            body = center
            if len(chain) > 10:
                raise EphemerisFormatError("segment chain does not reach SSB")
        self._ssb_chains[target] = chain
        return chain

    def ssb_posvel(self, target: int, et):
        """Chain segments to the SSB (center 0): km, km/s."""
        et = np.asarray(et, dtype=np.float64)
        pos, vel = None, None
        for body, center in self.ssb_chain(target):
            p, v = self._eval_pair(self.pairs[(body, center)], et)
            pos = p if pos is None else pos + p
            vel = v if vel is None else vel + v
        return pos, vel

    @property
    def bodies(self):
        return sorted({t for t, _ in self.pairs})


def _eval_type23(seg: Segment, et: np.ndarray):
    """Chebyshev evaluation; vectorized over epochs (numpy host path)."""
    scalar = et.ndim == 0
    et = np.atleast_1d(et)
    end = seg.init + seg.intlen * seg.n_records
    # refuse silent Chebyshev extrapolation (T_k diverges for |tau|>1);
    # 1 s of slack absorbs roundoff at the segment edges
    bad = (et < seg.init - 1.0) | (et > end + 1.0)
    if np.any(bad):
        raise EphemerisFormatError(
            f"{int(bad.sum())} epochs outside SPK segment coverage "
            f"[{seg.init}, {end}] s past J2000 "
            f"(target {seg.target} <- {seg.center})"
        )
    idx = np.floor((et - seg.init) / seg.intlen).astype(np.int64)
    idx = np.clip(idx, 0, seg.n_records - 1)
    mid = seg.mid[idx]
    radius = seg.radius[idx]
    tau = (et - mid) / radius  # in [-1, 1]
    coeffs = seg.coeffs[idx]  # (n, ncomp, ncoef)
    ncoef = coeffs.shape[-1]
    # Chebyshev polynomials and derivatives by recurrence
    T = np.zeros((len(et), ncoef))
    U = np.zeros((len(et), ncoef))
    T[:, 0] = 1.0
    if ncoef > 1:
        T[:, 1] = tau
        U[:, 1] = 1.0
    for k in range(2, ncoef):
        T[:, k] = 2.0 * tau * T[:, k - 1] - T[:, k - 2]
        U[:, k] = 2.0 * tau * U[:, k - 1] + 2.0 * T[:, k - 1] - U[:, k - 2]
    if seg.data_type == 2:
        pos = np.einsum("nck,nk->nc", coeffs, T)
        vel = np.einsum("nck,nk->nc", coeffs, U) / radius[:, None]
    else:
        pos = np.einsum("nck,nk->nc", coeffs[:, :3], T)
        vel = np.einsum("nck,nk->nc", coeffs[:, 3:], T)
    if scalar:
        return pos[0], vel[0]
    return pos, vel


def jd_to_et(jd1, jd2=0.0):
    """Two-part TDB Julian date -> ET seconds past J2000."""
    return (
        (np.asarray(jd1, dtype=np.float64) - J2000_JD) * S_PER_DAY
        + np.asarray(jd2, dtype=np.float64) * S_PER_DAY
    )


def mjd_tdb_to_et(mjd_int, sec_of_day):
    """(integer MJD(TDB), seconds-of-day) -> ET seconds past J2000;
    the split keeps sub-ns resolution in f64 (|et| < 2^53 ns)."""
    return (
        (np.asarray(mjd_int, dtype=np.float64) - 51544.5) * S_PER_DAY
        + np.asarray(sec_of_day, dtype=np.float64)
    )


# -- writer (round-trip tests + ephemeris caching) ------------------------
def write_spk_type2(
    path,
    segments: list[dict],
    ifname: str = "pint_tpu spk",
):
    """Write a little-endian type-2 SPK.

    Each segment dict: target, center, frame, init, intlen,
    coeffs (n_rec, ncomp, ncoef) — ncomp 3 for position segments, 1 for
    DE-t style TDB-TT time segments (target >= 1000000000).
    """
    word_buf: list[float] = []

    def addr():  # 1-based address of the NEXT word written
        return len(word_buf) + 1

    summaries = []
    for sd in segments:
        coeffs = np.asarray(sd["coeffs"], dtype=np.float64)
        n_rec, ncomp, ncoef = coeffs.shape
        if ncomp not in (1, 3) or (
            ncomp == 1 and sd["target"] < 1000000000
        ):
            raise EphemerisFormatError(
                "type 2 segments have 3 components (1 only for "
                "time-ephemeris targets >= 1000000000)"
            )
        init, intlen = float(sd["init"]), float(sd["intlen"])
        rsize = 2 + ncomp * ncoef
        ia = addr()
        for r in range(n_rec):
            mid = init + intlen * (r + 0.5)
            word_buf.append(mid)
            word_buf.append(intlen / 2.0)
            word_buf.extend(coeffs[r].ravel().tolist())
        word_buf.extend([init, intlen, float(rsize), float(n_rec)])
        ib = addr() - 1
        summaries.append((
            init, init + intlen * n_rec,
            sd["target"], sd["center"], sd.get("frame", 1), 2, ia, ib,
        ))

    n_data_words = len(word_buf)
    # layout: record 1 = file record, record 2 = summary, record 3 =
    # names, data from record 4
    data_start_word = 3 * (RECLEN // 8) + 1
    free = data_start_word + n_data_words

    with open(path, "wb") as f:
        filerec = bytearray(RECLEN)
        filerec[0:8] = b"DAF/SPK "
        struct.pack_into("<ii", filerec, 8, 2, 6)
        filerec[16:76] = ifname.encode()[:60].ljust(60)
        struct.pack_into("<iii", filerec, 76, 2, 2, free)
        filerec[88:96] = b"LTL-IEEE"
        # FTP integrity string (constant)
        ftp = b"FTPSTR:\r:\n:\r\n:\r\x00:\x81:\x10\xce:ENDFTP"
        filerec[699:699 + len(ftp)] = ftp
        f.write(filerec)

        sumrec = bytearray(RECLEN)
        struct.pack_into("<ddd", sumrec, 0, 0.0, 0.0, float(len(summaries)))
        off = 24
        for (et0, et1, tg, ct, fr, ty, ia, ib) in summaries:
            struct.pack_into("<dd", sumrec, off, et0, et1)
            struct.pack_into(
                "<6i", sumrec, off + 16,
                tg, ct, fr, ty, ia + data_start_word - 1,
                ib + data_start_word - 1,
            )
            off += 40
        f.write(sumrec)

        namerec = bytearray(RECLEN)
        for k in range(len(summaries)):
            namerec[k * 40:(k + 1) * 40] = b"pint_tpu segment".ljust(40)
        f.write(namerec)

        f.write(np.asarray(word_buf, dtype="<f8").tobytes())
        # pad to record boundary
        rem = (n_data_words * 8) % RECLEN
        if rem:
            f.write(b"\x00" * (RECLEN - rem))


def chebyshev_fit_records(fn, t0, t1, n_records, degree, ncomp=3):
    """Fit fn(t)->(...,ncomp) over [t0, t1] as n_records Chebyshev
    pieces of the given degree; returns coeffs (n_records, ncomp,
    degree+1) for write_spk_type2.  Used to build kernels from analytic
    ephemerides (and 1-component TDB-TT time ephemerides)."""
    intlen = (t1 - t0) / n_records
    ncoef = degree + 1
    # Chebyshev-Gauss nodes
    k = np.arange(ncoef)
    nodes = np.cos(np.pi * (k + 0.5) / ncoef)  # in (-1, 1)
    Tmat = np.cos(
        np.outer(np.arange(ncoef), np.arccos(nodes))
    )  # (ncoef, ncoef): T_i(node_j)
    out = np.zeros((n_records, ncomp, ncoef))
    for r in range(n_records):
        mid = t0 + intlen * (r + 0.5)
        rad = intlen / 2.0
        samples = fn(mid + rad * nodes)  # (ncoef, ncomp)
        # discrete Chebyshev transform
        c = 2.0 / ncoef * (Tmat @ samples)  # (ncoef, ncomp)
        c[0] *= 0.5
        out[r] = c.T
    return out
