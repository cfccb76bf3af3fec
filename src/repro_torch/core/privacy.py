"""The privacy wire: pairwise secure-aggregation pads and differential
privacy as the fifth round axis (counterpart of ``repro.core.privacy``).

``secure_agg`` -- pairwise one-time pads on the wire buffers. Every
undirected edge (i, j) shares a pad stream drawn by the splitmix32
counter hash of ``core.dynamics`` from the privacy key (``priv_key`` in
``FLState.comm``), the shared round counter and the undirected pair
index, so both endpoints derive it and nobody else can. The sender adds
the pad to every wire buffer at the bit level (:func:`mask_wire`) before
the transfer and the receiver removes it after: what crosses the wire
looks like noise, and what the mix consumes is bit-identical to the
unmasked round (mask then unmask is the identity in Z_2^w). The pads are
antisymmetric, ``m_ij = -m_ji (mod 2^w)``, the sign fixed by ``sender <
receiver``. They take physical effect only on a wire that carries a
payload per edge (``sharded_fused``'s circulant torus wire); the fused
engine has no per-edge payload, so there ``secure_agg`` is a no-op.

``dp`` -- per-node L2 clip of the wire payload plus Gaussian noise,
folded into the wire stage's quantize epilogue by residual substitution
(``kernels.gossip.ops``: still one kernel launch a round), with the
(epsilon, delta) moments bound reported as the ``dp_epsilon`` metric.
Error feedback absorbs clip and noise as it absorbs the quantization
error.

Spec grammar (the ``--fl-privacy`` strings), ``+``-separated tokens::

    none                                   the default, no privacy
    secure_agg[:seed=S]                    pairwise pads only
    dp:sigma=0.5,clip=1.0[,delta=1e-5][,seed=S]
                                           clip + Gaussian noise only
    secure_agg+dp:sigma=0.5,clip=1.0       both

RNG streams (clear of the topology programs' 1-4 and the node programs'
11-13): pads use ``PAD_STREAM + buffer_index``, DP noise ``NOISE_STREAM``
and ``NOISE_STREAM + 1``; the DSGT tracker wire offsets both by
``TRACKER_STREAM_OFFSET``.

The hash is uint32 arithmetic, emulated in int64 on values in [0, 2^32)
as ``core.dynamics`` does, so every draw is bitwise the reference's on
any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.dynamics import _M32, _as_key, _mix32, _mul32

__all__ = [
    "PrivacySpec",
    "NONE",
    "parse_privacy",
    "resolve_privacy",
    "PAD_STREAM",
    "NOISE_STREAM",
    "TRACKER_STREAM_OFFSET",
    "pair_index",
    "pad_bits",
    "mask_buffer",
    "mask_wire",
    "dp_noise",
    "rdp_epsilon",
    "analytic_epsilon",
    "epsilon_traced",
]

#: base stream of the pairwise pads; buffer i of a wire uses PAD_STREAM + i
PAD_STREAM = 21
#: stream of the DP Gaussian draw (Box-Muller takes NOISE_STREAM and
#: NOISE_STREAM + 1)
NOISE_STREAM = 41
#: the DSGT tracker wire offsets every privacy stream by this constant
TRACKER_STREAM_OFFSET = 8


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """What the wire stage does to the payload: ``secure_agg`` turns on
    the pairwise pads; ``dp_sigma > 0`` the per-node L2 clip to
    ``dp_clip`` plus Gaussian noise of standard deviation ``dp_sigma *
    dp_clip`` (the clip is the sensitivity). ``delta`` is the accounting
    target; ``seed`` derives ``priv_key``."""

    secure_agg: bool = False
    dp_sigma: float = 0.0
    dp_clip: float = 0.0
    delta: float = 1e-5
    seed: int = 0

    def __post_init__(self) -> None:
        if self.dp_sigma < 0.0 or self.dp_clip < 0.0:
            raise ValueError(
                f"dp_sigma/dp_clip must be >= 0, got "
                f"sigma={self.dp_sigma} clip={self.dp_clip}"
            )
        if self.dp_sigma > 0.0 and self.dp_clip <= 0.0:
            raise ValueError(
                "dp_sigma > 0 needs dp_clip > 0: the clip is the "
                "sensitivity the noise is calibrated to "
                "(dp:sigma=S,clip=C)"
            )
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")

    @property
    def dp(self) -> bool:
        return self.dp_sigma > 0.0

    @property
    def needs_rng(self) -> bool:
        """Whether the spec draws from the counter hash at round time."""
        return self.secure_agg or self.dp

    @property
    def active(self) -> bool:
        return self.secure_agg or self.dp

    def spec(self) -> str:
        """Canonical spec string; ``parse_privacy(s.spec()) == s``."""
        parts = []
        if self.secure_agg:
            tok = "secure_agg"
            if self.seed != 0 and not self.dp:
                tok += f":seed={self.seed}"
            parts.append(tok)
        if self.dp:
            tok = f"dp:sigma={self.dp_sigma!r},clip={self.dp_clip!r}"
            if self.delta != 1e-5:
                tok += f",delta={self.delta!r}"
            if self.seed != 0:
                tok += f",seed={self.seed}"
            parts.append(tok)
        return "+".join(parts) if parts else "none"

    def init_key(self) -> np.ndarray:
        """The (2,) uint32 base key ``priv_key``, derived from ``seed``."""
        with np.errstate(over="ignore"):
            s = np.uint32(self.seed)
            gamma = np.uint32(0x9E3779B9)
            k0 = _np_mix32(s + gamma)
            k1 = _np_mix32(s + gamma * np.uint32(2) + np.uint32(0x5851F42D))
        return np.asarray([k0, k1], np.uint32)


def _np_mix32(x) -> np.ndarray:
    """The splitmix32 finalizer in numpy uint32 (init-time only)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return x


NONE = PrivacySpec()


def _parse_knobs(body: str, where: str) -> dict:
    out = {}
    for item in body.split(","):
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"malformed privacy knob {item!r} in {where!r} (expected k=v)"
            )
        k, v = item.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def parse_privacy(spec: str) -> PrivacySpec:
    """Parse a ``--fl-privacy`` spec string (grammar in the module
    docstring)."""
    s = spec.strip()
    if s in ("", "none"):
        return NONE
    secure_agg = False
    kw = {}
    for token in s.split("+"):
        token = token.strip()
        name, _, body = token.partition(":")
        name = name.strip()
        if name == "secure_agg":
            secure_agg = True
            for k, v in _parse_knobs(body, token).items():
                if k != "seed":
                    raise ValueError(f"unknown secure_agg knob {k!r} (only seed=)")
                kw["seed"] = int(v)
        elif name == "dp":
            names = {"sigma": ("dp_sigma", float), "clip": ("dp_clip", float),
                     "delta": ("delta", float), "seed": ("seed", int)}
            for k, v in _parse_knobs(body, token).items():
                if k not in names:
                    raise ValueError(
                        f"unknown dp knob {k!r} (sigma=, clip=, delta=, seed=)")
                field, cast = names[k]
                kw[field] = cast(v)
            if "dp_sigma" not in kw:
                raise ValueError(f"dp token needs sigma= (got {token!r})")
        else:
            raise ValueError(
                f"unknown privacy token {name!r} in {spec!r}; known: "
                f"none, secure_agg, dp:sigma=,clip=[,delta=][,seed=]"
            )
    return PrivacySpec(secure_agg=secure_agg, **kw)


def resolve_privacy(privacy: Union[None, str, PrivacySpec]) -> PrivacySpec:
    """None, a spec string or a PrivacySpec -> PrivacySpec."""
    if privacy is None:
        return NONE
    if isinstance(privacy, PrivacySpec):
        return privacy
    if isinstance(privacy, str):
        return parse_privacy(privacy)
    raise TypeError(
        f"privacy must be None, a spec string, or a PrivacySpec, got "
        f"{type(privacy).__name__}"
    )


# ---------------------------------------------------------------------------
# the pairwise pads
# ---------------------------------------------------------------------------


def _u32(x, device=None) -> torch.Tensor:
    """An integer (or integer tensor) read as int32 and reinterpreted as
    uint32, held in int64."""
    return torch.as_tensor(x, device=device).to(torch.int32).to(torch.int64) & _M32


def pair_index(a, b, n: int):
    """Undirected pair counter ``min * n + max``: both endpoints of an edge
    derive the same pad stream from it."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.minimum(a, b) * n + torch.maximum(a, b)


def pad_bits(key, r, pair, idx, stream: int) -> torch.Tensor:
    """Raw uint32 pad words (in int64): a pure counter hash of the (2,)
    base key, the round counter ``r``, the undirected ``pair`` index, the
    per-element counter ``idx`` and a per-buffer ``stream`` constant.
    ``pair`` and ``idx`` broadcast against each other."""
    key = _as_key(key)
    dev = key.device
    s = _mix32(key[0] ^ int(stream))
    t = _mix32(key[1] ^ _u32(r, dev))
    p = _mix32(_mul32(_u32(pair, dev), 0x9E3779B9) ^ s)
    idx = torch.as_tensor(idx, device=dev).to(torch.int64) & _M32
    return _mix32(idx ^ p ^ _mul32(t, 0x85EBCA6B))


#: wire dtype -> (the same-width integer dtype it is viewed as, its width)
_INT_VIEW = {
    torch.float32: (torch.int32, 32),
    torch.int32: (torch.int32, 32),
    torch.int16: (torch.int16, 16),
    torch.int8: (torch.int8, 8),
    torch.uint8: (torch.uint8, 8),
}


def mask_buffer(buf: torch.Tensor, pad_u32: torch.Tensor, sender_lt,
                unmask: bool = False) -> torch.Tensor:
    """Apply (or, with ``unmask``, remove) one wire buffer's pairwise pad
    at the bit level. Signed integers and floats are viewed as the
    same-width integer and the sign-applied pad is added mod 2^w (the
    uint32 pad truncated to the width: truncation commutes with negation,
    so ``m_ij = -m_ji`` at every width). Unsigned buffers (the bitmap
    wire) are XORed with the pad, its own inverse. Mask then unmask is
    the identity. ``sender_lt``: broadcastable bool, True where sender <
    receiver."""
    if buf.dtype not in _INT_VIEW:
        raise ValueError(f"no mask rule for wire dtype {buf.dtype}")
    view, bits = _INT_VIEW[buf.dtype]
    width = (1 << bits) - 1
    if buf.dtype == torch.uint8:
        return buf ^ (pad_u32 & width).to(torch.uint8)
    pad = pad_u32 & _M32
    neg = (-pad) & _M32
    lt = torch.as_tensor(sender_lt, device=buf.device)
    signed = torch.where(lt, pad, neg)
    if unmask:
        signed = (-signed) & _M32
    u = (buf.view(view).to(torch.int64) + signed) & width
    u = u - ((u >> (bits - 1)) << bits)  # back to the signed range
    return u.to(view).view(buf.dtype)


def mask_wire(wire: Sequence[torch.Tensor], key, r, pair, sender_lt,
              stream_base: int = PAD_STREAM,
              unmask: bool = False) -> Tuple[torch.Tensor, ...]:
    """Mask (or unmask) every buffer of one wire for one edge. ``wire``:
    (rows, width_i) buffers; ``pair`` / ``sender_lt``: the (rows,) edge
    identities. Buffer i uses stream ``stream_base + i``."""
    out = []
    for i, buf in enumerate(wire):
        if buf.ndim != 2:
            raise ValueError(f"wire buffer {i} must be (rows, width), got {tuple(buf.shape)}")
        idx = torch.arange(buf.shape[1], dtype=torch.int64, device=buf.device)[None, :]
        pad = pad_bits(key, r, torch.as_tensor(pair, device=buf.device).reshape(-1, 1),
                       idx, stream_base + i)
        lt = torch.as_tensor(sender_lt, device=buf.device).reshape(-1, 1)
        out.append(mask_buffer(buf, pad, lt, unmask=unmask))
    return tuple(out)


# ---------------------------------------------------------------------------
# DP noise
# ---------------------------------------------------------------------------


def _u01_bits(key, r, idx: torch.Tensor, stream: int) -> torch.Tensor:
    h = pad_bits(key, r, 0, idx, stream)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def dp_noise(key, r, node_ids, width: int, scale, stream: int = NOISE_STREAM
             ) -> torch.Tensor:
    """Per-node Gaussian wire noise ``scale * N(0, 1)`` of shape ``(rows,
    width)`` on the key's device: Box-Muller over two counter-hash
    uniforms with the GLOBAL element counter ``node * width + col``, so a
    rank that draws only its own rows gets bitwise the rows of the
    whole-matrix draw."""
    key = _as_key(key)
    dev = key.device
    ids = torch.as_tensor(node_ids, device=dev).to(torch.int64).reshape(-1, 1)
    col = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    idx = (ids * width + col) & _M32
    u1 = torch.clamp_min(_u01_bits(key, r, idx, stream), 1.0 / (1 << 24))
    u2 = _u01_bits(key, r, idx, stream + 1)
    two_pi = float(np.float32(2.0 * math.pi))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    return float(np.float32(scale)) * z


# ---------------------------------------------------------------------------
# (epsilon, delta) accounting
# ---------------------------------------------------------------------------


def rdp_epsilon(sigma: float, steps: int, delta: float,
                alphas: Optional[np.ndarray] = None) -> float:
    """The moments (RDP) accountant on a fine alpha grid: each wire
    release is a Gaussian mechanism with noise multiplier ``sigma``, RDP
    ``alpha / (2 sigma^2)``; ``steps`` releases compose additively and
    the conversion adds ``log(1/delta) / (alpha - 1)``. Returns the grid
    minimum."""
    if sigma <= 0.0:
        return float("inf")
    if steps <= 0:
        return 0.0
    if alphas is None:
        alphas = 1.0 + np.geomspace(1e-4, 1e6, 20001)
    alphas = np.asarray(alphas, np.float64)
    eps = steps * alphas / (2.0 * sigma * sigma) + np.log(1.0 / delta) / (alphas - 1.0)
    return float(np.min(eps))


def analytic_epsilon(sigma: float, steps: int, delta: float) -> float:
    """The continuous optimum of the RDP bound:
    ``eps = T / (2 s^2) + sqrt(2 T log(1/delta)) / s``."""
    if sigma <= 0.0:
        return float("inf")
    if steps <= 0:
        return 0.0
    return steps / (2.0 * sigma * sigma) + math.sqrt(
        2.0 * steps * math.log(1.0 / delta)) / sigma


def epsilon_traced(sigma: float, steps, delta: float) -> torch.Tensor:
    """fp32 twin of :func:`analytic_epsilon` for the per-round
    ``dp_epsilon`` metric (a 0-dim tensor on the host)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    t = torch.clamp_min(torch.as_tensor(steps, dtype=torch.float32), 0.0)
    return t / f32(2.0 * sigma * sigma) + torch.sqrt(
        2.0 * t * f32(math.log(1.0 / delta))) / f32(sigma)
