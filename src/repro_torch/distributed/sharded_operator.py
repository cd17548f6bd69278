"""ShardedKernelOperator — the KernelOperator contract over a row-sharded x,
the port of ``repro.distributed.sharded_operator``.

The same primitives as ``core.operator.KernelOperator`` — ``matvec``,
``row_block_matvec``, ``block``/``block_idx``, ``gather_rows``,
``trace_est``, ``restrict``/``with_points`` and the multi-kernel tuner's
``matvec_cols``/``sketch_components`` — over an ``x`` whose rows are split
across the "data" axis of a :class:`~repro_torch.distributed.meshes.
SolverMesh`.  Every collective is explicit (the mesh's ``psum`` /
``all_gather``); all local compute goes through a plain per-shard operator
(``core.multikernel.make_operator``) on the shard's device, so each shard
launches the same CUDA kernels a single-device solve does.

Layout (rows = the "data" axis, S row shards, M model shards):

  * ``x`` (n, d) is held as per-device row shards (``x_shards``: shard i on
    every device of mesh row i; a view where that device holds the global
    ``x``).
  * iterates / RHS (n,) or (n, t) are row-sharded arrays, held as their
    global view on the mesh's home device (its first): shard i reads rows
    ``[i n/S, (i+1) n/S)`` of it, and a row-sharded result is assembled
    there.  Callers (``blocked_cg``, the tune engine, residual reports)
    therefore take them as plain tensors.
  * block points, indices and the outputs of ``row_block_matvec`` /
    ``block`` / ``gather_rows`` are replicated; the home device's copy is
    returned.

Per-primitive collectives (t RHS columns):

  primitive                 collectives
  ------------------------  -------------------------------------------------
  matvec                    all_gather x, v over rows; psum over model
  row_block_matvec          psum over rows (+ all_gather over model when M | b)
  block                     all_gather over model (when M | b)
  gather_rows / block_idx   ONE packed psum over rows
  trace_est                 none (n for the unit-diagonal kernels)

The ``shard_*`` composites are the same pieces for a solver-owned mapped
body (``distributed/krr_dist.py``): a value there is a dict from mesh
coordinate to a tensor on that coordinate's device, and the composites
issue the collectives themselves.

Each global primitive counts its collectives into
``repro_collective_dispatch_total{primitive=..., collective=...}``
(``repro_torch.obs.metrics``) where the reference does, and only when the
axis has more than one shard; the composites count nothing.

``matvec`` gathers the whole of x on every device, as the reference does:
with ``cuda:0`` x 4 at n = 10^6 and d = 9 that is four 36 MB copies on one
card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.nystrom import cholesky_or_nan
from repro_torch.distributed.meshes import SolverMesh
from repro_torch.obs.metrics import counter as _obs_counter

MODEL_AXIS = "model"
ROW_AXIS = "data"


def _count_collective(primitive: str, collective: str, count: int = 1) -> None:
    """Tally ``count`` dispatches of a collective inside ``primitive``."""
    if count:
        _obs_counter(
            "repro_collective_dispatch_total",
            labels={"primitive": primitive, "collective": collective},
            help="host-side dispatches of mesh collectives by primitive",
        ).inc(count)


def _map(fn, *parts: dict) -> dict:
    """``{c: fn(p0[c], p1[c], ...)}`` over the coordinates of ``parts[0]``."""
    return {c: fn(*(p[c] for p in parts)) for c in parts[0]}


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def split_rows(mesh: SolverMesh, v: torch.Tensor, n_loc: int, dim: int = 0) -> dict:
    """Row shard i (``n_loc`` rows along ``dim``) of the global view ``v``
    on each device of mesh row i (a view where the device holds ``v``)."""
    return mesh.each(
        lambda c: v.narrow(dim, c[0] * n_loc, n_loc).to(mesh.device(c), non_blocking=True))


def join_rows(mesh: SolverMesh, parts: dict, dim: int = 0) -> torch.Tensor:
    """The global view on the home device of a row-sharded result: the
    row shards of model shard 0, concatenated along ``dim`` in order."""
    pieces = [parts[(i, 0)].to(mesh.home, non_blocking=True)
              for i in range(mesh.shape[ROW_AXIS])]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


@dataclasses.dataclass(frozen=True)
class ShardedKernelOperator:
    """Mesh-aware linear-operator view of K = K(x, x).

    Build a bound operator with :meth:`bind`.  ``x=None`` is an *unbound*
    operator: the (mesh, kernel-config) view whose ``shard_*`` composites
    serve solver-owned mapped bodies (``krr_dist.make_dist_askotch_step``).
    """

    mesh: SolverMesh
    x: torch.Tensor | None = None  # global view on mesh.home
    kernel: str | tuple[str, ...] = "rbf"
    sigma: float | tuple[float, ...] = 1.0
    chunk_a: int = 4096
    chunk_b: int = 8192
    weights: tuple[float, ...] | None = None  # multi-kernel combination
    precision: str = "f32"  # tile-compute policy: "f32" | "bf16"
    x_shards: dict | None = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        if isinstance(self.kernel, list):
            object.__setattr__(self, "kernel", tuple(self.kernel))
        if isinstance(self.sigma, list):
            object.__setattr__(self, "sigma", tuple(self.sigma))
        if self.weights is not None:
            object.__setattr__(self, "weights", tuple(float(w) for w in self.weights))

    # -- construction --------------------------------------------------------

    @classmethod
    def bind(cls, mesh: SolverMesh, x, **cfg) -> "ShardedKernelOperator":
        """Split ``x`` into row shards on ``mesh`` and return a bound
        operator; raises unless the row-shard count divides n."""
        op = cls(mesh=mesh, x=None, **cfg)
        x = _as_tensor(x)
        n = x.shape[0]
        if n % op.n_row_shards != 0:
            raise ValueError(
                f"n = {n} rows do not shard evenly over {op.n_row_shards} row "
                f"shard(s) of mesh axes {op.rows}; pad the dataset or pick a "
                f"mesh whose row-axis product divides n"
            )
        x_home = x.to(mesh.home)
        shards = split_rows(mesh, x_home, n // op.n_row_shards)
        return dataclasses.replace(op, x=x_home, x_shards=shards)

    # -- mesh/axis structure -------------------------------------------------

    @property
    def rows(self) -> tuple[str, ...]:
        """The mesh axes sharding rows."""
        return (ROW_AXIS,)

    @property
    def n_row_shards(self) -> int:
        """Number of row shards S."""
        return self.mesh.shape[ROW_AXIS]

    @property
    def n_model(self) -> int:
        """Size M of the "model" axis."""
        return self.mesh.shape[MODEL_AXIS]

    @property
    def n(self) -> int:
        """Global row count of the bound x."""
        self._require_bound()
        return self.x.shape[0]

    @property
    def d(self) -> int:
        """Feature dimension of the row points."""
        self._require_bound()
        return self.x.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        """(n, n) — the global kernel matrix shape this operator applies."""
        return (self.n, self.n)

    @property
    def n_loc(self) -> int:
        """Rows per shard, n / S."""
        return self.n // self.n_row_shards

    def _require_bound(self) -> None:
        if self.x is None:
            raise ValueError(
                "operator is unbound (x=None); global-array primitives need "
                "a bound operator — use ShardedKernelOperator.bind(mesh, x)"
            )

    # -- local views ---------------------------------------------------------

    def local_op(self, pts: torch.Tensor):
        """Per-shard operator over ``pts`` (on their device) — the ONLY
        kernel dispatch point of the distributed stack.  A kernel TUPLE
        yields a per-shard weighted-sum operator."""
        from repro_torch.core.multikernel import make_operator

        return make_operator(
            pts, kernel=self.kernel, sigma=self.sigma, weights=self.weights,
            chunk_a=self.chunk_a, chunk_b=self.chunk_b, precision=self.precision,
        )

    def rows_of(self, v: torch.Tensor, dim: int = 0) -> dict:
        """Shard i's rows of a row-sharded global view ``v`` (along
        ``dim``) on each device of mesh row i."""
        return split_rows(self.mesh, v, self.n_loc, dim)

    def assemble(self, parts: dict, dim: int = 0) -> torch.Tensor:
        """The global view on the home device of a row-sharded result."""
        return join_rows(self.mesh, parts, dim)

    # -- derived operators ---------------------------------------------------

    def with_points(self, x_new) -> "ShardedKernelOperator":
        """Same configuration over a different (row-shardable) row set."""
        return ShardedKernelOperator.bind(
            self.mesh, x_new, kernel=self.kernel, sigma=self.sigma,
            chunk_a=self.chunk_a, chunk_b=self.chunk_b, weights=self.weights,
            precision=self.precision,
        )

    def restrict(self, idx):
        """Operator over ``x[idx]``: the rows are gathered (one packed psum)
        and returned as a plain operator on the home device."""
        (xb,), _owned = self.gather_rows(idx)
        return self.local_op(xb)

    # -- shard-level composites (values are {coord: tensor} dicts) ----------

    def model_slice(self, arr: dict, loc: int) -> dict:
        """Each model shard's ``loc``-row slice of a replicated array."""
        if self.n_model == 1:
            return arr
        return {c: a[c[1] * loc:(c[1] + 1) * loc] for c, a in arr.items()}

    def model_all_gather(self, arr: dict, dim: int = 0) -> dict:
        """all_gather over "model" (no-op on a size-1 axis)."""
        return self.mesh.all_gather(arr, MODEL_AXIS, dim) if self.n_model > 1 else arr

    def model_psum(self, arr: dict) -> dict:
        """psum over "model" (no-op on a size-1 axis)."""
        return self.mesh.psum(arr, MODEL_AXIS) if self.n_model > 1 else arr

    def row_psum(self, arr: dict) -> dict:
        """psum over the row axis (no-op with one row shard)."""
        return self.mesh.psum(arr, ROW_AXIS) if self.n_row_shards > 1 else arr

    def shard_gather_rows(self, x_l: dict, idx: dict, extras: tuple[dict, ...] = ()):
        """Packed-psum gather of global rows ``idx`` from the row shards.

        ``x_l``: each device's (n_loc, d) rows; each extra a row-aligned
        (n_loc,) or (n_loc, t) shard.  ONE psum over rows moves x and every
        extra together.  Returns ``((x_B, *extras_B), owned, local_pos)``:
        the gathered rows on every device, plus each shard's ownership mask
        and clipped local positions (the scatter-back coordinates).
        """
        flat = [False] + [next(iter(e.values())).ndim == 1 for e in extras]

        def pack(c):
            xl, ix = x_l[c], idx[c]
            n_loc = xl.shape[0]
            lo = c[0] * n_loc
            pos = torch.clamp(ix - lo, 0, n_loc - 1)
            owned = ((ix >= lo) & (ix < lo + n_loc)).to(xl.dtype)
            cols = [xl.index_select(0, pos)]
            for e in extras:
                tile = e[c].index_select(0, pos).to(xl.dtype)
                cols.append(tile[:, None] if tile.ndim == 1 else tile)
            return torch.cat(cols, dim=1) * owned[:, None], owned, pos, [t.shape[1] for t in cols]

        packed_l = self.mesh.each(pack)
        widths = next(iter(packed_l.values()))[3]
        packed = self.row_psum({c: p[0] for c, p in packed_l.items()})
        outs = []
        off = 0
        for w, one_d in zip(widths, flat):
            outs.append({c: (p[:, off] if one_d else p[:, off:off + w]) for c, p in packed.items()})
            off += w
        return (tuple(outs), {c: p[1] for c, p in packed_l.items()},
                {c: p[2] for c, p in packed_l.items()})

    def shard_row_block_matvec(self, x_l: dict, a_l: dict, v_l: dict) -> dict:
        """K(a_l, x) @ v — each shard's partial K(a_l, x_l) @ v_l, psum'd
        over rows.  ``a_l``: this model shard's block rows; ``v_l``: the
        (n_loc[, t]) row shard."""
        part = _map(lambda x, a, v: self.local_op(x).row_block_matvec(a, v), x_l, a_l, v_l)
        return self.row_psum(part)

    def shard_block_slice(self, arr: dict) -> dict:
        """This model shard's rows of a replicated block array (b, ...)."""
        if self.n_model == 1:
            return arr
        b = next(iter(arr.values())).shape[0]
        if b % self.n_model:
            raise ValueError(
                f"block of {b} rows does not shard over {self.n_model} model "
                f"shard(s); round the block size up to a multiple of "
                f"{self.n_model}"
            )
        return self.model_slice(arr, b // self.n_model)

    def shard_block_nystrom(self, xb: dict, rank: int, omega_raw: torch.Tensor):
        """Distributed rank-r Nystrom of K_BB, U rows sharded over "model".

        ``xb``: the replicated (b, d) block; ``omega_raw``: the replicated
        (b, r) Gaussian draw (orthonormalized here, once, and copied to each
        distinct device).  Each model shard computes its (b/M, r) sketch rows
        with one kernel matvec; the two r x r Grams are psum'd over "model";
        the eigh of B^T B is replicated.  Returns ``(u_l, lam)``: each
        shard's (b/M, r) rows of U and the (r,) Nystrom eigenvalues.
        """
        b = next(iter(xb.values())).shape[0]
        omega = self.mesh.replicate(torch.linalg.qr(omega_raw)[0])
        xb_l = self.shard_block_slice(xb)
        omega_l = self.shard_block_slice(omega)
        shift = float(np.float32(1.19e-7) * np.float32(b))  # eps * tr(K_BB), unit diagonal
        y_sketch = _map(
            lambda xf, xl, om, oml: self.local_op(xf).row_block_matvec(xl, om) + shift * oml,
            xb, xb_l, omega, omega_l)
        gram = self.model_psum(_map(lambda oml, ys: oml.T @ ys, omega_l, y_sketch))

        def factor(g, ys):
            g = 0.5 * (g + g.T)
            chol = cholesky_or_nan(g + 1e-6 * torch.eye(rank, dtype=g.dtype, device=g.device))
            return torch.linalg.solve_triangular(chol, ys.T, upper=False).T

        b_mat = _map(factor, gram, y_sketch)
        btb = self.model_psum(_map(lambda bm: bm.T @ bm, b_mat))

        def basis(g, bm):
            evals, evecs = torch.linalg.eigh(g)
            evals, evecs = evals.flip(0), evecs.flip(1)
            s_vals = torch.sqrt(torch.clamp_min(evals, 1e-30))
            return bm @ (evecs / s_vals[None, :]), torch.clamp_min(evals - shift, 0.0)

        out = _map(basis, btb, b_mat)
        return {c: o[0] for c, o in out.items()}, {c: o[1] for c, o in out.items()}

    def shard_woodbury_apply(self, u_l: dict, lam_ny: dict, rho: dict, g_l: dict) -> dict:
        """(U diag(lam) U^T + rho I)^{-1} g with U rows sharded over "model";
        ``g_l`` (b/M,) or (b/M, t): one r[ x t] psum over "model"."""
        utg = self.model_psum(_map(lambda u, g: u.T @ g, u_l, g_l))

        def apply(u, lam, r, ut, g):
            scale = lam + r
            scaled = ut / (scale[:, None] if ut.ndim == 2 else scale)
            return u @ scaled + (g - u @ ut) / r

        return _map(apply, u_l, lam_ny, rho, utg, g_l)

    def shard_woodbury_invsqrt(self, u_l: dict, lam_ny: dict, rho: dict, g_l: dict) -> dict:
        """(U diag(lam) U^T + rho I)^{-1/2} g — Eq. (16) on model-sharded U."""
        utg = self.model_psum(_map(lambda u, g: u.T @ g, u_l, g_l))

        def apply(u, lam, r, ut, g):
            scale = torch.sqrt(lam + r)
            scaled = ut / (scale[:, None] if ut.ndim == 2 else scale)
            return u @ scaled + (g - u @ ut) / torch.sqrt(r)

        return _map(apply, u_l, lam_ny, rho, utg, g_l)

    def shard_block_powering(self, xb: dict, u_l: dict, lam_ny: dict, rho: dict,
                             lam: float, v0: dict, num_iters: int):
        """get_L (Algorithm 5) on the preconditioned distributed block: the
        top eigenvalue of P^{-1/2} (K_BB + lam I) P^{-1/2}.  ``v0``: the
        replicated (b,) start vector.  Returns ``(v_last, L_estimate)``."""
        b = next(iter(xb.values())).shape[0]
        b_loc = b // self.n_model
        xb_l = self.shard_block_slice(xb)

        def kbb_lam_mv(v_full: dict) -> dict:  # (b,) replicated -> (b/M,) local
            part = _map(lambda xf, xl, v: self.local_op(xf).row_block_matvec(xl, v),
                        xb, xb_l, v_full)
            return _map(lambda p, vs: p + lam * vs, part, self.model_slice(v_full, b_loc))

        v = _map(lambda v: v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30), v0)
        lam_est = None
        for _ in range(num_iters):
            v_l = self.model_slice(v, b_loc)
            u1 = self.shard_woodbury_invsqrt(u_l, lam_ny, rho, v_l)
            u2 = kbb_lam_mv(self.model_all_gather(u1))
            u3 = self.shard_woodbury_invsqrt(u_l, lam_ny, rho, u2)
            stats = self.model_psum(_map(lambda a, u: torch.stack([a @ u, u @ u]), v_l, u3))
            lam_est = {c: s[0] for c, s in stats.items()}
            v = self.model_all_gather(
                _map(lambda u, s: u / torch.clamp_min(torch.sqrt(s[1]), 1e-30), u3, stats))
        if lam_est is None:
            lam_est = _map(lambda a: torch.ones((), dtype=a.dtype, device=a.device), v)
        return v, lam_est

    # -- the primitives over global arrays -----------------------------------

    def _contract(self, primitive: str, v: torch.Tensor, local, out_dim: int = 0) -> torch.Tensor:
        """K(x, x)-shaped contraction of a row-sharded ``v``: gather x and v
        over rows on every device, split the contraction over "model" when
        M | n, and assemble the row-sharded result (``out_dim`` its row
        axis).  ``local(c, op_cols, x_rows, v_cols)`` is the per-shard
        kernel call at mesh coordinate ``c``."""
        mesh, n, m_sh = self.mesh, self.n, self.n_model
        x_full = mesh.all_gather(self.x_shards, ROW_AXIS)
        v_full = mesh.all_gather(self.rows_of(v), ROW_AXIS)
        split = m_sh > 1 and n % m_sh == 0
        sl = n // m_sh

        def body(c):
            xf, vf = x_full[c], v_full[c]
            if split:
                xf, vf = xf[c[1] * sl:(c[1] + 1) * sl], vf[c[1] * sl:(c[1] + 1) * sl]
            return local(c, self.local_op(xf), self.x_shards[c], vf)

        out = mesh.each(body)
        if split:
            out = mesh.psum(out, MODEL_AXIS)
        if self.n_row_shards > 1:
            _count_collective(primitive, "all_gather", 2)  # x and v
        if split:
            _count_collective(primitive, "psum")
        return self.assemble(out, out_dim)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K(x, x) @ v; v row-sharded (n,) or (n, t) -> same layout out."""
        self._require_bound()
        return self._contract("matvec", v, lambda c, op, xr, vc: op.row_block_matvec(xr, vc))

    def _require_multikernel(self) -> None:
        if not isinstance(self.kernel, tuple):
            raise ValueError(
                "per-column-weighted primitives need a multi-kernel operator "
                f"(a kernel tuple); got kernel={self.kernel!r}"
            )

    def matvec_cols(self, v: torch.Tensor, w_cols) -> torch.Tensor:
        """Per-column-weighted multi-kernel matvec: out[:, c] =
        (sum_i w_cols[i, c] K_i) @ v[:, c]; v row-sharded (n, t), ``w_cols``
        replicated (q, t)."""
        self._require_bound()
        self._require_multikernel()
        wc = self.mesh.replicate(_as_tensor(w_cols).to(torch.float32))
        return self._contract(
            "matvec_cols", v,
            lambda c, op, xr, vc: op.row_block_matvec_cols(xr, vc, wc[c]))

    def sketch_components(self, omega: torch.Tensor) -> torch.Tensor:
        """Stacked per-kernel sketches (q, n, r): out[i] = K_i @ omega, rows
        sharded on axis 1."""
        self._require_bound()
        self._require_multikernel()
        return self._contract(
            "sketch_components", omega,
            lambda c, op, xr, vc: op.row_block_components(xr, vc), out_dim=1)

    def row_block_matvec(self, a, v: torch.Tensor) -> torch.Tensor:
        """K(a, x) @ v for a replicated row block ``a`` (b, d); v row-sharded
        (n,)|(n, t) -> replicated (b,)|(b, t) (the home device's copy)."""
        self._require_bound()
        mesh = self.mesh
        a = _as_tensor(a)
        b = a.shape[0]
        split = self.n_model > 1 and b % self.n_model == 0
        a_c = mesh.replicate(a)
        a_l = self.model_slice(a_c, b // self.n_model) if split else a_c
        part = self.shard_row_block_matvec(self.x_shards, a_l, self.rows_of(v))
        if split:
            part = self.model_all_gather(part)
        if self.n_row_shards > 1:
            _count_collective("row_block_matvec", "psum")
        if split:
            _count_collective("row_block_matvec", "all_gather")
        return part[(0, 0)]

    def block(self, a, b=None) -> torch.Tensor:
        """Materialize K(a, b) for replicated point sets (small tiles only);
        rows of ``a`` split over "model" when divisible."""
        a = _as_tensor(a)
        b = a if b is None else _as_tensor(b)
        m_sh = self.n_model
        if m_sh == 1 or a.shape[0] % m_sh:
            home = self.mesh.home
            a_h, b_h = a.to(home), b.to(home)
            return self.local_op(b_h).block(a_h, b_h)  # replicated compute
        a_c, b_c = self.mesh.replicate(a), self.mesh.replicate(b)
        a_l = self.model_slice(a_c, a.shape[0] // m_sh)
        tiles = _map(lambda al, bc: self.local_op(bc).block(al, bc), a_l, b_c)
        _count_collective("block", "all_gather")
        return self.model_all_gather(tiles)[(0, 0)]

    def block_idx(self, idx) -> torch.Tensor:
        """K_BB for a replicated global row-index block (ASkotch step)."""
        (xb,), _ = self.gather_rows(idx)
        return self.block(xb, xb)

    def gather_rows(self, idx, *extras: torch.Tensor):
        """Gather ``x[idx]`` (+ row-aligned extras) to every device via ONE
        packed psum.  Returns ``((x_B, *extras_B), owned)``: the gathered
        arrays (home copies) and the row-sharded (S * b,) ownership mask."""
        self._require_bound()
        idx_c = self.mesh.replicate(_as_tensor(idx).to(torch.int64))
        outs, owned, _pos = self.shard_gather_rows(
            self.x_shards, idx_c, tuple(self.rows_of(e) for e in extras))
        if self.n_row_shards > 1:
            _count_collective("gather_rows", "psum")  # one packed psum
        return tuple(o[(0, 0)] for o in outs), self.assemble(owned)

    def trace_est(self) -> torch.Tensor:
        """tr K — no collective: n for the unit-diagonal testbed kernels; a
        weighted combination scales by its weight sum."""
        tr = self.n
        if isinstance(self.kernel, tuple) and self.weights is not None:
            tr = sum(self.weights) * self.n
        return torch.tensor(tr, dtype=torch.float32, device=self.mesh.home)

    # -- composites shared by solvers ----------------------------------------

    def k_lam_matvec(self, v: torch.Tensor, lam) -> torch.Tensor:
        """(K + lam I) @ v, row-sharded in and out."""
        return self.matvec(v) + lam * v

    def sketch(self, omega: torch.Tensor) -> torch.Tensor:
        """K @ omega for a row-sharded (n, r) test matrix."""
        return self.matvec(omega)
