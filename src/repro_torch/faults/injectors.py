"""Fault injectors: bitcast bit-flips + stateful sticky re-application.

The injector is the stateful half of a :class:`~repro_torch.faults.model.
FaultModel`: it decides when the fault fires, draws the target
coordinates once (seeded), and — for sticky kinds — RE-APPLIES the same
corruption every step, which is what distinguishes a stuck-at cell from
a transient upset: a retry that rereads the operand gets the corruption
back.

The port's counterpart of the JAX package's ``repro/faults/injectors.py``.
The fault process itself stays numpy: the timing (``fires``), the
coordinate draws from ``default_rng(model.seed)`` and the latch are the
reference's line for line, so both packages corrupt the SAME element with
the SAME bits.  The site hooks take the port's torch trees: an operand is
corrupted in a clone on its own device (an integer view XORs the bit
there — no round trip through host memory, which matters for the stacked
LM weights: gemma-2b's MLP input stack is 4.8 GB in f32), and the clone
comes back with the input's device and dtype.  The master operand is
never written.  :func:`flip_bits` is the reference's numpy upset model,
exported as the reference exports it; :func:`flip_bits_tensor` is its
tensor twin.

The one device-side site, the kernel accumulator, reuses the
``inject=(layer, stripe, slot, delta)`` hook that the spmm/fused/network
kernels honour.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .model import FaultModel

_UINT_FOR = {4: np.uint32, 8: np.uint64}
# the signed integer view, by element width, a tensor's bits are flipped in
_INT_FOR = {4: torch.int32, 8: torch.int64}


def flip_bits(arr: np.ndarray, flat_index: int, bit: int) -> np.ndarray:
    """Return a copy of ``arr`` with ``bit`` XOR-flipped in the element at
    ``flat_index`` — the bitcast upset model (works for f32/f64 via the
    matching uint view, and for integer dtypes directly)."""
    arr = np.array(arr)          # contiguous writable copy
    flat = arr.reshape(-1)
    if arr.dtype.kind == "f":
        u = _UINT_FOR.get(arr.dtype.itemsize)
        if u is None:
            raise ValueError(f"no uint view for dtype {arr.dtype}")
        bits = flat.view(u)
        bits[flat_index] ^= u(1 << (bit % (8 * arr.dtype.itemsize)))
    elif arr.dtype.kind in "iu":
        width = 8 * arr.dtype.itemsize
        flat[flat_index] = flat[flat_index] ^ arr.dtype.type(
            1 << (bit % width))
    else:
        raise ValueError(f"cannot bit-flip dtype {arr.dtype}")
    return arr


def _signed_mask(bit: int, width: int) -> int:
    """``1 << bit`` as a two's-complement ``width``-bit signed integer: the
    sign bit (31 of an int32, 63 of an int64) is a negative mask, which
    XORs the same bits an unsigned view's ``1 << bit`` does."""
    m = 1 << (bit % width)
    return m - (1 << width) if m >= 1 << (width - 1) else m


def _flip_tensor_(flat: torch.Tensor, flat_index: int, bit: int) -> None:
    """In place: XOR ``bit`` of element ``flat_index`` of the 1-D tensor
    ``flat`` — the tensor twin of :func:`flip_bits` (f32/f64 through the
    signed integer view of their width, int32/int64 directly)."""
    itype = _INT_FOR.get(flat.element_size())
    if itype is None or not (flat.dtype.is_floating_point
                             or flat.dtype == itype):
        raise ValueError(f"cannot bit-flip dtype {flat.dtype}")
    flat.view(itype)[flat_index] ^= _signed_mask(bit,
                                                 8 * flat.element_size())


def flip_bits_tensor(t: torch.Tensor, flat_index: int, bit: int
                     ) -> torch.Tensor:
    """A clone of ``t`` (same device, same dtype) with ``bit`` XOR-flipped
    in the element at ``flat_index``: bit for bit what :func:`flip_bits`
    gives for the same array."""
    out = t.clone(memory_format=torch.contiguous_format)
    _flip_tensor_(out.reshape(-1), int(flat_index), bit)
    return out


class FaultInjector:
    """Stateful fault process for one :class:`FaultModel` over a run.

    Usage per step ``t``::

        if inj.fires(t):
            params = inj.apply_params(params)        # weights / w_r
            cols, vals, h0 = inj.apply_batch(cols, vals, h0)
            inject = inj.kernel_inject()             # accumulator

    ``fires`` latches sticky kinds; the ``apply_*`` hooks then corrupt
    the SAME coordinates to the SAME values on every subsequent step —
    re-applying (not accumulating) the corruption, so a clean rewrite of
    the cell between steps is undone exactly once.
    """

    def __init__(self, model: FaultModel):
        self.model = model
        self.rng = np.random.default_rng(model.seed)
        self.latched = False
        self.first_fired_step: Optional[int] = None
        self._bern: Dict[int, bool] = {}
        # per-target-array sticky state: key -> [(flat_index, value)];
        # the value is a 0-d tensor (the stuck bits, on the operand's
        # device), a numpy scalar for the host-side column table
        self._stuck: Dict[str, List[Tuple[int, object]]] = {}

    # -- timing -----------------------------------------------------------

    def fires(self, step_idx: int) -> bool:
        m = self.model
        if m.sticky and self.latched:
            return True
        if m.timing == "targeted":
            fired = (step_idx >= m.step) if m.sticky \
                else (step_idx == m.step)
        else:
            if step_idx not in self._bern:
                self._bern[step_idx] = bool(self.rng.random() < m.p)
            fired = self._bern[step_idx]
        if fired:
            self.latched = self.latched or m.sticky
            if self.first_fired_step is None:
                self.first_fired_step = step_idx
        return fired

    # -- corruption core --------------------------------------------------

    def _coords(self, key: str, size: int) -> List[int]:
        n = self.model.n_upsets
        if self.model.index is not None:
            base = self.model.index % size
            return [(base + k) % size for k in range(n)]
        state = self._stuck.get(key)
        if state is not None:
            return [i for i, _ in state]
        return [int(i) for i in self.rng.choice(size, size=min(n, size),
                                                replace=False)]

    def corrupt_array(self, key: str, arr: torch.Tensor) -> torch.Tensor:
        """Corrupt a clone of one target tensor on its own device,
        latching sticky values."""
        out = arr.clone(memory_format=torch.contiguous_format)
        self._corrupt_tensor_(key, out)
        return out

    def _corrupt_tensor_(self, key: str, t: torch.Tensor) -> None:
        """In place on the contiguous tensor ``t`` (a clone the caller
        owns)."""
        m = self.model
        flat = t.view(-1)
        state = self._stuck.get(key)
        if state is not None:
            # sticky re-application: same cells, same stuck values
            for i, v in state:
                flat[i] = v
            return
        coords = self._coords(key, flat.numel())
        for i in coords:
            if m.kind == "stuck" and m.stuck_value is not None:
                flat[i] = m.stuck_value
            else:
                _flip_tensor_(flat, i, m.bit)
        if m.sticky:
            # a 0-d clone holds the stuck bits exactly (NaN payload too)
            self._stuck[key] = [(i, flat[i].clone()) for i in coords]

    # -- site hooks -------------------------------------------------------

    def apply_params(self, params):
        """weights / w_r sites: corrupt one layer's W or its folded
        checksum column source, returning a shallow-copied params tree."""
        m = self.model
        if m.site not in ("weights", "w_r"):
            return params
        field = "w" if m.site == "weights" else "w_r"
        layers = list(params["layers"])
        layer = dict(layers[m.layer % len(layers)])
        if field not in layer:
            raise ValueError(f"fault site {m.site!r} needs params with a "
                             f"folded {field!r} entry (run fold_w_r first)")
        layer[field] = self.corrupt_array(field, layer[field])
        layers[m.layer % len(layers)] = layer
        return {**params, "layers": layers}

    def apply_batch(self, cols, vals, h0):
        """features / cols_table sites: corrupt the packed operand tensors
        (h0 in a clone on its own device)."""
        m = self.model
        if m.site == "features":
            h0 = self.corrupt_array("h0", h0)
        elif m.site == "cols_table":
            # the column table is small (stripes x width): corrupt it on
            # the host and hand it back where it came from
            host = self._corrupt_cols(cols.detach().cpu().numpy())
            cols = torch.from_numpy(host).to(cols.device)
        return cols, vals, h0

    def _corrupt_cols(self, cols: np.ndarray) -> np.ndarray:
        m = self.model
        cols = np.array(cols)
        n_cols = int(cols.max()) + 1 if cols.size else 1
        flat = cols.reshape(-1)
        state = self._stuck.get("cols")
        if state is not None:
            for i, v in state:
                flat[i] = v
            return cols
        coords = self._coords("cols", flat.size)
        for i in coords:
            if m.kind == "stuck" and m.stuck_value is not None:
                v = int(m.stuck_value)
                flat[i] = v % n_cols
            else:
                # a corrupted index must still land on a valid column
                # block (a wild pointer traps instead of silently
                # corrupting — the interesting case is the silent one)
                v = int(flat[i])
                flat[i] = (v ^ (1 << (m.bit % 8))) % n_cols
        if m.sticky:
            self._stuck["cols"] = [(i, flat[i]) for i in coords]
        return cols

    def apply_graph(self, graph):
        """s_c site: corrupt the dense path's offline adjacency column
        checksum stashed on the Graph (trusted verbatim by the engine —
        exactly why the self-check must re-derive it)."""
        if self.model.site != "s_c":
            return graph
        if graph.s_c is None:
            raise ValueError("fault site 's_c' needs a Graph with a "
                             "staged s_c (run one forward first or pass "
                             "it explicitly)")
        graph.s_c = self.corrupt_array("s_c", graph.s_c)
        graph._s_c_auto = False      # user-provided values are trusted
        return graph

    def kernel_inject(self) -> Optional[Tuple[int, int, int, float]]:
        """accumulator site: the kernel ``inject=`` tuple, or None."""
        m = self.model
        if m.site != "accumulator":
            return None
        return (m.layer, m.stripe, m.slot, m.delta)

    # -- LM site hooks ----------------------------------------------------

    def apply_lm_params(self, params):
        """qkv_w / mlp_w sites: corrupt one layer's slice of the stacked
        transformer weights (``attn.wq.w`` / ``mlp.wi.w``, shape
        ``[L, d_in, *out]``) in a shallow-copied param tree.  The offline
        fold (``w_r``) is left pristine, so the corruption is the
        detectable post-load memory-fault class.  The stack is cloned on
        its device and corrupted there."""
        m = self.model
        if m.site not in ("qkv_w", "mlp_w"):
            return params
        path = ("attn", "wq") if m.site == "qkv_w" else ("mlp", "wi")
        segments = list(params["segments"])
        for si, seg in enumerate(segments):
            for uname in sorted(seg):
                unit = seg[uname]
                blk = unit.get(path[0]) if isinstance(unit, dict) else None
                dns = blk.get(path[1]) if isinstance(blk, dict) else None
                if not (isinstance(dns, dict) and "w" in dns):
                    continue
                # [L, d_in, *out]
                w = dns["w"].clone(memory_format=torch.contiguous_format)
                self._corrupt_tensor_(m.site, w[m.layer % w.shape[0]])
                segments[si] = {**seg, uname: {
                    **unit, path[0]: {**blk, path[1]: {**dns, "w": w}}}}
                return {**params, "segments": segments}
        raise ValueError(f"fault site {m.site!r}: no "
                         f"{'/'.join(path)} dense in the param tree")

    def lm_inject(self) -> float:
        """attn_accumulator site: the ``attn_inject`` operand delta for
        this step (0.0 when the site is something else)."""
        m = self.model
        return m.delta if m.site == "attn_accumulator" else 0.0
