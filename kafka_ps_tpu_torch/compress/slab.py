"""Device-resident training slab in f32, bf16 or int8 storage
(counterpart of kafka_ps_tpu/compress/slab.py).

The worker trains on its buffer slab ([cap, F] x, labels, validity mask)
every iteration.  `SlabStore` keeps that slab on the device and applies
only the rows `SlidingBuffer` marked dirty: O(changed rows) bytes per
arrival instead of the whole slab.

`--slab-dtype bf16|int8` stores x reduced: bf16 halves and int8 (per-row
max-abs scale) about quarters the bytes the solver reads per step.  The
host always ships f32 rows; encoding runs on the device after the copy,
and the solver decodes inside its kernel (K3, K5 in ops/fused_update.py)
exactly as `decode_x` does, so the kernel and the plain version train on
the same decoded values.  Labels and mask stay exact.  The encodes are
bitwise the JAX package's: `quantize_rows` is the same max-abs / 127,
division and round-half-to-even, and bf16 is a round-to-nearest-even
cast in both.

The changed-row count is padded to a power-of-two bucket (never below
MIN_BUCKET) with a sentinel slot == capacity, so host→device copies
keep a handful of shapes.  torch has no scatter mode that drops
out-of-range indices, so the device tensors (x, or q and scale, y, mask)
carry one spare row at index `capacity`: every sentinel lands there and
`arrays()` slices it off.  Real slots are unique (a drained set), so the
only repeated index is the sentinel's, and index_copy_'s unordered writes
touch nothing that is read.  Incremental and full uploads give
bitwise-equal slabs in every storage form.  With telemetry on,
`slab_upload_bytes_total{path=full|incremental}` mirrors the host bytes
each path shipped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY

SLAB_DTYPES = ("f32", "bf16", "int8")
MIN_BUCKET = 4


def quantize_rows(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-abs int8 quantization over the last axis of a 2-D block:
    [n, c] f32 → (q [n, c] int8, scale [n] f32), bit for bit the JAX
    package's (torch.round rounds half to even, as jnp.round does).

    The divisor 127 is a tensor, not a Python number: PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal, which puts a
    scale 1 ulp off the division on some rows; a tensor divisor divides,
    on the card as on the CPU."""
    amax = r.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(r / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_rows (up to the quantization error)."""
    return q.to(torch.float32) * scale[..., None]


class QuantizedSlab(NamedTuple):
    """int8 slab storage: rows quantized with a per-row scale."""

    q: torch.Tensor       # [cap, F] int8
    scale: torch.Tensor   # [cap, 1] f32  (max|row| / 127)


def slab_kind(x) -> str:
    """Storage form of a slab: "f32", "bf16" or "int8" (QuantizedSlab).
    Raises TypeError on anything else."""
    if isinstance(x, QuantizedSlab):
        return "int8"
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float32:
            return "f32"
        if x.dtype == torch.bfloat16:
            return "bf16"
    raise TypeError("a slab is a float32 or bfloat16 tensor or a "
                    f"QuantizedSlab, got {getattr(x, 'dtype', type(x))}")


def slab_batch_shape(x) -> tuple[int, int]:
    """(batch, num_features) of a slab in any storage form."""
    a = x.q if isinstance(x, QuantizedSlab) else x
    return a.shape[-2], a.shape[-1]


def decode_x(x) -> torch.Tensor:
    """Stored slab → f32: bf16 widens exactly, int8 is one f32 multiply
    per element (q · scale of its row); f32 comes back as it is."""
    if isinstance(x, QuantizedSlab):
        return x.q.to(torch.float32) * x.scale
    return x.to(torch.float32)


def encode_x(dtype: str, x: torch.Tensor):
    """f32 rows → stored form."""
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        q, scale = quantize_rows(x)
        return QuantizedSlab(q=q, scale=scale[..., None])
    return x


class SlabStore:
    """One worker's device-resident training slab.

    `upload_full` replaces the whole slab (bootstrap, mass-delete churn,
    or every change under `--full-slab-upload`); `apply_rows` scatters a
    drained dirty set into it.  `bytes_uploaded` counts the f32 host
    bytes each path shipped, as the reference does."""

    def __init__(self, dtype: str, capacity: int, num_features: int,
                 device, telemetry=None):
        if dtype not in SLAB_DTYPES:
            raise ValueError(f"slab dtype {dtype!r} not in {SLAB_DTYPES}")
        self.dtype = dtype
        self.capacity = capacity
        self.num_features = num_features
        self.device = torch.device(device)
        self._x = None            # [cap+1, F] tensor, or a QuantizedSlab
        self._y = None
        self._mask = None
        self.bytes_uploaded = 0
        self.full_uploads = 0
        self.incremental_applies = 0
        self.rows_applied = 0
        # the metrics mirror of bytes_uploaded by upload path (host
        # array sizes: no device sync)
        telemetry = telemetry or NULL_TELEMETRY
        self._telemetry = telemetry
        self._m_full = telemetry.counter("slab_upload_bytes_total",
                                         path="full")
        self._m_rows = telemetry.counter("slab_upload_bytes_total",
                                         path="incremental")

    @property
    def ready(self) -> bool:
        return self._x is not None

    def upload_full(self, x, y, mask) -> None:
        """Host slab copy → device store (plus the zeroed spare row),
        encoded on the device."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.int32)
        mask = np.ascontiguousarray(mask, dtype=np.float32)
        self.bytes_uploaded += x.nbytes + y.nbytes + mask.nbytes
        self.full_uploads += 1
        if self._telemetry.enabled:
            self._m_full.inc(x.nbytes + y.nbytes + mask.nbytes)
        cap, dev = self.capacity, self.device
        sx = torch.zeros((cap + 1, self.num_features), dtype=torch.float32,
                         device=dev)
        sy = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
        sm = torch.zeros((cap + 1,), dtype=torch.float32, device=dev)
        sx[:cap].copy_(torch.from_numpy(x))
        sy[:cap].copy_(torch.from_numpy(y))
        sm[:cap].copy_(torch.from_numpy(mask))
        self._x, self._y, self._mask = encode_x(self.dtype, sx), sy, sm

    def apply_rows(self, slots, xr, yr, mr) -> None:
        """Scatter the changed rows into the device slab, the row count
        padded to a power-of-two bucket with sentinel slots."""
        n = int(len(slots))
        if n == 0:
            return
        if not self.ready:
            raise RuntimeError("apply_rows before the first upload_full")
        b = MIN_BUCKET
        while b < n:
            b *= 2
        pad = b - n
        slots_p = np.concatenate(
            [np.asarray(slots, np.int32),
             np.full((pad,), self.capacity, np.int32)])
        xr_p = np.concatenate(
            [np.asarray(xr, np.float32),
             np.zeros((pad, self.num_features), np.float32)])
        yr_p = np.concatenate(
            [np.asarray(yr, np.int32), np.zeros((pad,), np.int32)])
        mr_p = np.concatenate(
            [np.asarray(mr, np.float32), np.zeros((pad,), np.float32)])
        self.bytes_uploaded += (slots_p.nbytes + xr_p.nbytes
                                + yr_p.nbytes + mr_p.nbytes)
        self.incremental_applies += 1
        self.rows_applied += n
        if self._telemetry.enabled:
            self._m_rows.inc(slots_p.nbytes + xr_p.nbytes
                             + yr_p.nbytes + mr_p.nbytes)
        dev = self.device
        idx = torch.from_numpy(slots_p).to(dev, dtype=torch.int64)
        enc = encode_x(self.dtype, torch.from_numpy(xr_p).to(dev))
        # in place: a kernel already queued on this stream that reads the
        # slab runs before these copies, so no reader sees a torn slab
        if isinstance(self._x, QuantizedSlab):
            self._x.q.index_copy_(0, idx, enc.q)
            self._x.scale.index_copy_(0, idx, enc.scale)
        else:
            self._x.index_copy_(0, idx, enc)
        self._y.index_copy_(0, idx, torch.from_numpy(yr_p).to(dev))
        self._mask.index_copy_(0, idx, torch.from_numpy(mr_p).to(dev))

    def arrays(self):
        """(x, y [cap] int32, mask [cap] f32) device views without the
        spare row, all contiguous; x in the storage form: a [cap, F] f32
        or bf16 tensor, or a QuantizedSlab."""
        if not self.ready:
            raise RuntimeError("slab store read before first upload")
        cap = self.capacity
        x = self._x
        if isinstance(x, QuantizedSlab):
            x = QuantizedSlab(q=x.q[:cap], scale=x.scale[:cap])
        else:
            x = x[:cap]
        return x, self._y[:cap], self._mask[:cap]

    def device_bytes(self) -> int:
        """Bytes of the slab the solver reads (x in its storage form, y
        and mask), the spare row left out."""
        if not self.ready:
            return 0
        x, y, mask = self.arrays()
        parts = tuple(x) if isinstance(x, QuantizedSlab) else (x,)
        return sum(t.nbytes for t in (*parts, y, mask))


class ParamPageSlab:
    """The hot tier of the tiered parameter store (store/tiered.py): page
    index -> float32 tensor on `device`, the server's device.

    `put` uploads a host array (counted in `bytes_uploaded` and
    `uploads`) and keeps a tensor as it is: an apply's output stays
    where it was computed, so a hot page's steady state moves no host
    bytes.  A tensor on another device is refused, never moved quietly.
    Page tensors are replaced whole and never written in place (the
    server's replacement rule), so a reader may keep one it fetched.
    Copies run on the current stream of the calling thread, which for
    every thread of a run is the default stream: an upload or a fetch
    is ordered after the kernels queued before it."""

    def __init__(self, device):
        from kafka_ps_tpu_torch.utils.config import canonical_device
        self.device = canonical_device(device)
        self._pages: dict[int, torch.Tensor] = {}
        self.bytes_uploaded = 0
        self.uploads = 0

    def __contains__(self, page: int) -> bool:
        return page in self._pages

    def __len__(self) -> int:
        return len(self._pages)

    def upload(self, values: np.ndarray) -> torch.Tensor:
        """A host array's copy on the slab's device (counted), not yet
        installed."""
        host = np.ascontiguousarray(values, dtype=np.float32)
        self.bytes_uploaded += host.nbytes
        self.uploads += 1
        return torch.tensor(host, device=self.device)

    def put(self, page: int, values) -> torch.Tensor:
        """Install a page value and return the stored tensor."""
        if isinstance(values, np.ndarray):
            values = self.upload(values)
        elif values.device != self.device:
            raise ValueError(f"page {page} is on {values.device}, the hot "
                             f"tier on {self.device}")
        self._pages[page] = values
        return values

    def get(self, page: int) -> torch.Tensor:
        return self._pages[page]

    def pop_host(self, page: int) -> np.ndarray:
        """A demotion's fetch: the page leaves the slab as a host array."""
        return self._pages.pop(page).detach().to("cpu").numpy().copy()

    def drop(self, page: int) -> None:
        self._pages.pop(page, None)

    def device_bytes(self) -> int:
        """Bytes of the resident pages."""
        return sum(t.nbytes for t in list(self._pages.values()))
