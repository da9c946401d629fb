"""Differentiable ISDF: the state (x_k, w_q) as a function of atom positions.

Counterpart of ``fftisdf_tpu/isdf/autodiff.py``.  Every stage of the
ISDF approximant -- Bloch AO evaluation, the stripe-trick normal equations,
the fitting solve, the FFT Coulomb metric -- is a torch function of the
atom positions, so ``torch.autograd`` differentiates the whole compressed
ERI with respect to nuclear coordinates.

Semantics: the interpolation points (grid positions chosen by selection)
and the per-shell lattice-image lists are held fixed (they are discrete);
the AO values at those points, and everything downstream, are
differentiated.  This is the exact derivative of the ISDF approximant for
the frozen point set.

The forward build (``basis.eval``, ``isdf.kpoint``) writes into
preallocated tensors and works in place, which autograd refuses or
differentiates wrongly, and bakes the atom centres into its tensors.  The
twins here take the positions as an argument and allocate every
intermediate: :func:`make_evaluator_diff` is the positions-traced Bloch AO
evaluator (the shell tables and solid harmonics are the build's),
:func:`_rhs_full` the JAX package's full-phase RHS, and the fit is the
port's :func:`~fftisdf_tpu_torch.linalg.solvers.solve_fitting` followed by
one FFT per sector, as in the JAX package.

Remat: the JAX package's ``jax.checkpoint`` is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, and its
``FIT_FACTOR_POLICY`` (save the fitting factor, recompute the rest) is a
selective checkpoint whose policy saves the outputs of the Cholesky and
eigh calls (:func:`fit_factor_context`).  ``jax.lax.map`` over sectors and
grid blocks is a Python loop.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from fftisdf_tpu_torch.basis.eval import (_S00, _CHI_BLOCK_BYTES,
                                          _group_by_center, build_shell_table,
                                          group_specs)
from fftisdf_tpu_torch.basis.gto import real_solid_harmonics
from fftisdf_tpu_torch.isdf.eri import assemble_eri
from fftisdf_tpu_torch.isdf.kpoint import _stripe_quartic
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.coulomb import get_coulG
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.linalg.solvers import solve_fitting
from fftisdf_tpu_torch.parallel.mesh import (check_mesh, enter, gather_rows,
                                             grid_to_sector, split)
from fftisdf_tpu_torch.utils.device import real_complex, resolve_device

# the factorisations of the fitting solve: saved, not recomputed, under
# fit_factor_context (their recompute noise is amplified by 1/rcond)
_FIT_FACTOR_OPS = {
    torch.ops.aten.linalg_cholesky_ex.default,
    torch.ops.aten.linalg_eigh.default,
}


def _fit_factor_policy(ctx, op, *args, **kwargs):
    if op in _FIT_FACTOR_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def fit_factor_context():
    """Selective-checkpoint context of the JAX package's
    ``FIT_FACTOR_POLICY``: a checkpointed region recomputes everything in
    the backward pass but the fitting factorisations, which it saves."""
    return create_selective_checkpoint_contexts(_fit_factor_policy)


def _ckpt(fn, *args, policy=False):
    ctx = {"context_fn": fit_factor_context} if policy else {}
    return checkpoint(fn, *args, use_reentrant=False, **ctx)


# a region whose largest intermediate stays below this many bytes keeps its
# intermediates: recomputing it would cost more than the memory it frees
REMAT_MIN_BYTES = 2**30


def _remat(fn, *args, nbytes, policy=False):
    """fn(*args), checkpointed when autograd records and the region's
    largest intermediate (``nbytes``) is at least REMAT_MIN_BYTES."""
    if torch.is_grad_enabled() and nbytes >= REMAT_MIN_BYTES:
        return _ckpt(fn, *args, policy=policy)
    return fn(*args)


class _Recompute(torch.autograd.Function):
    """``fn(*args)`` run without a graph, and again, with one, in its own
    backward pass: a checkpoint whose recomputation happens when its node
    runs, on every rank alike.  A collective inside ``fn`` (the chunk's
    exchange of a sharded state) then meets the other ranks' in the same
    order, where the lazy recomputation of ``torch.utils.checkpoint``
    (triggered by the first saved tensor that the backward pass reads)
    would run it at different points on ranks whose graphs differ."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.tensor_at = [i for i, a in enumerate(args)
                         if isinstance(a, torch.Tensor)]
        ctx.args = [None if i in ctx.tensor_at else a
                    for i, a in enumerate(args)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return fn(*args)

    @staticmethod
    def backward(ctx, g):
        args = list(ctx.args)
        leaves = []
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(t.requires_grad)
            if t.requires_grad:
                leaves.append(i)
        with torch.enable_grad():
            out = ctx.fn(*args)
        grads = torch.autograd.grad(out, [args[i] for i in leaves], g,
                                    allow_unused=True)
        full = [None] * len(args)
        for i, gi in zip(leaves, grads):
            full[i] = gi
        return (None, *full)


def _group_chi_diff(coords, specs, exps, centers):
    """chi of a center group, (ng, nT, nfunc), without in-place writes:
    the function order of ``basis.eval._group_chi`` (shell-major, m-major
    then contraction), differentiable in ``coords`` and ``centers``."""
    d = coords[:, None, :] - centers[None, :, :]
    dx, dy, dz = d.unbind(-1)
    r2 = dx * dx + dy * dy + dz * dz
    gauss = [torch.exp(r2[..., None] * -e) for e in exps]
    feats = []
    for l, rpow, nfunc, iexp, coeffs in specs:
        rad = gauss[iexp] @ coeffs                       # (g, T, nctr)
        for _ in range(rpow):
            rad = rad * r2[..., None]
        if l == 0:
            chi = (rad * _S00)[..., None, :]
        else:
            ang = torch.stack(real_solid_harmonics(dx, dy, dz, l, torch),
                              dim=-1)
            chi = ang[..., :, None] * rad[..., None, :]
        feats.append(chi.reshape(r2.shape + (nfunc,)))
    return torch.cat(feats, dim=-1)


class DiffGroups:
    """Host tables of the differentiable evaluators: per center group its
    shells (as device tensors), its frozen image list, and the atom it
    follows (the nearest one; GTH projector shells sit on their atom).

    ``groups`` holds (specs, exps, images (nT, 3), atom index)."""

    def __init__(self, cell, precision, shells, rdtype, device):
        precision = cell.precision if precision is None else precision
        table = build_shell_table(cell, precision, shells)
        groups = _group_by_center(cell, table)
        atom_xyz = np.asarray(cell.atom_coords(), dtype=np.float64)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=rdtype,
                                      device=device)
        self.groups = []
        self.max_chi_row = 1
        for g in groups:
            ia = int(np.argmin(np.linalg.norm(atom_xyz - g.center, axis=1)))
            specs, exps = group_specs(g, t)
            self.groups.append((specs, exps, np.asarray(g.images), ia))
            nprim = max(len(s.exps) for s in g.specs)
            self.max_chi_row = max(
                self.max_chi_row, len(g.images) * (g.nfunc + nprim + 8))
        self.rdtype = rdtype

    def block_size(self, ng, factor=4):
        """Grid rows per block: the build's chi budget, over ``factor``
        for the autograd intermediates a block keeps."""
        return int(max(64, min(ng, _CHI_BLOCK_BYTES // (
            factor * self.rdtype.itemsize * self.max_chi_row))))

    def remat(self, ng, factor=4):
        """Whether the intermediates of ``ng`` grid rows reach
        REMAT_MIN_BYTES, so that the blocks are worth checkpointing."""
        return (factor * self.rdtype.itemsize * self.max_chi_row * ng
                >= REMAT_MIN_BYTES)


def _blocked(block_fn, coords, nblk_rows, *args, ckpt=True):
    """block_fn over row blocks of ``coords`` (concatenated along the
    grid axis -2).  When the grid takes more than one block, each block is
    checkpointed while autograd records (and ``ckpt``): the backward pass
    re-evaluates one block at a time."""
    ng = coords.shape[0]
    if nblk_rows >= ng:
        return block_fn(coords, *args)
    grad = ckpt and torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)
    parts = []
    for g0 in range(0, ng, nblk_rows):
        c = coords[g0:g0 + nblk_rows]
        parts.append(_ckpt(block_fn, c, *args) if grad
                     else block_fn(c, *args))
    return torch.cat(parts, dim=-2)


def make_evaluator_diff(cell, kpts=None, precision=None, dtype=None,
                        shells=None, *, device="cuda"):
    """Positions-traced Bloch AO evaluator ``fn(coords, positions)`` with
    positions (natm, 3) a tensor; the image lists stay those of the
    reference geometry.  ``shells``: an explicit [(center, Shell)] list
    (e.g. the GTH projectors, ``scf.integrals._projector_shells``) instead
    of the cell basis; each shell follows its nearest atom.  Returns
    (nk, ng, nfunc) complex, or (ng, nfunc) real at the gamma point
    (``kpts=None``), on ``device``."""
    device = resolve_device(device)
    rdt, cdt = real_complex(dtype)
    tabs = DiffGroups(cell, precision, shells, rdt, device)
    gamma = kpts is None
    kpts_np = None if gamma else np.asarray(kpts)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=device)
    ainv, amat = t(np.linalg.inv(np.asarray(cell.a))), t(cell.a)
    kpts_t = None if gamma else t(kpts_np)
    groups = []
    for specs, exps, images, ia in tabs.groups:
        ph = None
        if not gamma:
            ang = images @ kpts_np.T                          # (T, nk)
            ph = (t(np.cos(ang)), t(np.sin(ang)))
        groups.append((specs, exps, t(images), ia, ph))

    def block(coords, positions):
        # wrap into the home cell: r = r0 + T, phi_k(r) = e^{ik.T} phi_k(r0)
        tvec = torch.floor(coords @ ainv) @ amat
        coords0 = coords - tvec
        out = []
        for specs, exps, images, ia, ph in groups:
            chi = _group_chi_diff(coords0, specs, exps,
                                  positions[ia][None, :] + images)
            if gamma:
                out.append(chi.sum(dim=1))
                continue
            chi_t = chi.transpose(1, 2)                       # (g, f, T)
            out.append(torch.complex((chi_t @ ph[0]).permute(2, 0, 1),
                                     (chi_t @ ph[1]).permute(2, 0, 1)))
        out = torch.cat(out, dim=-1)
        if not gamma:
            ang = tvec @ kpts_t.T                             # (g, k)
            out = out * torch.polar(torch.ones_like(ang), ang).T[:, :, None]
        return out

    def eval_fn(coords, positions, checkpoint=True):
        """``checkpoint=False`` inside a region that is checkpointed
        already: the blocks then keep their intermediates."""
        coords = torch.as_tensor(coords, dtype=rdt, device=device)
        positions = torch.as_tensor(positions, dtype=rdt, device=device)
        ng = coords.shape[0]
        return _blocked(block, coords, tabs.block_size(ng), positions,
                        ckpt=checkpoint and tabs.remat(ng))

    return eval_fn


def _rhs_full(f_k, x_k, phase, phase_cols):
    """The JAX package's ``_rhs_block`` restricted to the sectors of
    ``phase_cols``: y (nq, bg, nip) = phase_cols^T Re(phase fx)^2, with
    fx_k = conj(f_k) x_k^T, all out of place."""
    fx_k = torch.matmul(f_k.conj(), x_k.transpose(1, 2))   # (k, g, I)
    nk, bg, nip = fx_k.shape
    fx_s = (phase @ fx_k.reshape(nk, -1)).real
    y_s = torch.square(fx_s).to(phase.dtype)
    return (phase_cols.T @ y_s).reshape(phase_cols.shape[1], bg, nip)


def isdf_state_fn(cell, kpts, mask, m0=None, solver="ridge", rcond=1e-10,
                  dtype=None, remat=None, dev_mesh=None, use_trs=True,
                  max_memory_gb=None, omegas=None, *, device="cuda"):
    """Differentiable (x_k, w_q) builder for a frozen interpolation-point
    set: ``state(positions) -> (x_k, wq)`` with positions a (natm, 3)
    tensor on ``device``.  ``mask`` indexes the selection (parent) grid
    ``m0`` of a prior FFTISDF build.

    ``remat``: checkpoint each sector's solve/FFT pipeline, saving only the
    fit factor (:func:`fit_factor_context`); on by default below float64,
    as in the JAX package.

    ``use_trs``: time-reversal halving (w_{-q} = conj(w_q)): only canonical
    sectors run the solve and FFT, mirrors are conjugate-scattered (the
    scatter is differentiable, so the backward pass halves too).

    ``max_memory_gb``: byte budget of the sector-chunked state: when the
    (nq_canonical, ngrid, nip) RHS exceeds a quarter of it, canonical
    sectors run in checkpointed chunks, each sweeping the grid in
    checkpointed blocks and recomputing its own chunk-restricted RHS, in
    the forward and again in the backward pass; inside a chunk each sector
    is checkpointed with the fit-factor policy.  Live memory is bounded by
    about one chunk's RHS and one sector's pipeline.

    ``omegas``: extra range-separation parameters (``linalg.coulomb``
    convention; omega < 0 is the erfc-screened short range): ``wq`` is
    then (1 + len(omegas), nk, nip, nip) with kernel 0 the bare one; every
    kernel reuses the sector's fit and forward FFT.

    ``dev_mesh`` (``parallel.mesh.make_device_mesh``; ``device`` must be
    its rank's): the build's layout.  Each rank sweeps its share of the
    grid for every sector (of a chunk), one exchange hands each rank whole
    planes of its share of the sectors, which it solves, and the sectors
    are gathered, so every rank returns the whole state and runs the same
    loss; the backward pass runs the same layout in reverse (the exchange
    backwards, and the gradients of the ranks' shares summed where the
    replicated positions and x_k entered them, ``parallel.mesh.enter``).
    Every rank must call the state alike.  The remat policy is the same
    on every rank."""
    device = resolve_device(device)
    if check_mesh(dev_mesh) is not None and dev_mesh.device != device:
        raise ValueError(f"device {device} is not the mesh rank's "
                         f"{dev_mesh.device}")
    rdt, cdt = real_complex(dtype)
    if remat is None:
        remat = rdt != torch.float64
    m0 = cell.mesh if m0 is None else m0
    kpts = np.asarray(kpts)
    nk = len(kpts)
    kmesh = kpt_mod.kpts_to_kmesh(cell, kpts)
    phase_np = kpt_mod.get_phase(cell, kpts, kmesh)
    coords = cell.gen_uniform_grids()
    coords_sel = cell.gen_uniform_grids(m0)[np.asarray(mask)]
    mesh = tuple(int(m) for m in cell.mesh)
    ngrid = coords.shape[0]
    nip = coords_sel.shape[0]
    vol = float(cell.vol)
    gv = cell.get_Gv(mesh)
    kernels = (0.0,) + tuple(float(o) for o in (omegas or ()))
    multi = omegas is not None
    # (nk, nker, ng) host-built kernels, q-leading
    coulG = torch.stack([torch.stack([
        get_coulG(cell, q=q, gv=gv, omega=o, dtype=rdt, device=device)
        for o in kernels]) for q in kpts])
    t = lambda a, dt=rdt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
    phase = torch.complex(t(phase_np.real), t(phase_np.imag))
    tqr = t((coords @ kpts.T).T)
    eiqr = torch.polar(torch.ones_like(tqr), tqr)          # (nk, ng)
    coords_t = t(coords)
    coords_sel_t = t(coords_sel)
    fn = make_evaluator_diff(cell, kpts=kpts, dtype=rdt, device=device)

    # TRS canonical sectors (host constants)
    qsel = order = flip = None
    if use_trs:
        s_kpts = cell.get_scaled_kpts(kpts)
        mirror = np.array([kpt_mod.member(-s_kpts[q], s_kpts, strict=False)
                           for q in range(nk)])
        if (mirror < 0).any():
            mirror = np.arange(nk)      # a mesh without -k pairing
        cand = np.array([q for q in range(nk) if q <= mirror[q]])
        if len(cand) < nk:
            qsel = cand
            pos = {int(q): i for i, q in enumerate(cand)}
            order = torch.as_tensor(
                [pos[q] if q in pos else pos[int(mirror[q])]
                 for q in range(nk)], device=device)
            flip = torch.as_tensor([q not in pos for q in range(nk)],
                                   device=device)
    qs_full = np.arange(nk) if qsel is None else qsel

    # the rank's grid points and its sectors of a range of canonical
    # sectors (the whole grid and every sector without a mesh)
    size = 1 if dev_mesh is None else dev_mesh.size
    rank = 0 if dev_mesh is None else dev_mesh.rank
    goff = split(ngrid, size)
    coords_loc = coords_t[int(goff[rank]):int(goff[rank + 1])]

    def local(y, x4_c, pos, sector_fn):
        """The rank's sectors of the canonical sectors ``pos`` from the
        grid-split RHS y (len(pos), ngrid_loc, nip) and their normal
        matrices x4_c: the exchange, then ``sector_fn(x4_q, y_q, q)`` per
        own sector, stacked.  A rank with no sector of the range keeps y
        and x4_c in its graph, so that its backward pass meets the others
        in the same collectives."""
        qoff = split(len(pos), size)
        y = grid_to_sector(y, dev_mesh, qoff, goff)
        own = range(qoff[rank], qoff[rank + 1])
        if len(own):
            return torch.stack([sector_fn(x4_c[j], y[i], pos[j])
                                for i, j in enumerate(own)]), qoff
        return (y.new_zeros((0, len(kernels), nip, nip))
                + 0.0 * (y.sum() + x4_c.sum())), qoff

    def wq_of_solve(z_q, cg, ph):
        """Sector metrics (nker, nip, nip) from the fitted z_q (nip, ng):
        one forward FFT shared by every kernel."""
        spec = fft3(z_q * ph.conj()[None, :], mesh)
        return torch.stack([
            (ifft3(spec * cg[i], mesh) * ph[None, :] * (vol / ngrid))
            @ z_q.mH for i in range(cg.shape[0])])

    def per_q(x4_q, y_q, cg, ph):
        z_q, _ = solve_fitting(x4_q, y_q.T, method=solver, rcond=rcond)
        return wq_of_solve(z_q, cg, ph)

    def sector(x4_q, y_q, cg, ph, ckpt):
        if ckpt and torch.is_grad_enabled():
            return _ckpt(per_q, x4_q, y_q, cg, ph, policy=True)
        return per_q(x4_q, y_q, cg, ph)

    def finish(wq_sel):
        if qsel is not None:
            wq_sel = wq_sel[order]
            wq_sel = torch.where(flip[:, None, None, None], wq_sel.conj(),
                                 wq_sel)
        wq = wq_sel.transpose(0, 1)                    # (nker, nk, nip, nip)
        return wq if multi else wq[0]

    def prologue(positions):
        positions = torch.as_tensor(positions, dtype=rdt, device=device)
        x_k = fn(coords_sel_t, positions)
        return positions, x_k, _stripe_quartic(x_k, phase)

    budget = None if max_memory_gb is None else float(max_memory_gb)
    per_sector_gb = ngrid * nip * cdt.itemsize / 1e9
    if budget is None:
        def state(positions):
            positions, x_k, x4_k = prologue(positions)
            pos_r, x_r, x4_r = (enter(t, dev_mesh)
                                for t in (positions, x_k, x4_k))
            f_k = fn(coords_loc, pos_r)
            qs = torch.as_tensor(qs_full, device=device)
            y = _remat(_rhs_full, f_k, x_r, phase, phase[:, qs],
                       nbytes=nk * len(coords_loc) * nip * cdt.itemsize)
            del f_k
            wq_loc, qoff = local(y, x4_r[qs], qs_full, lambda x4_q, y_q, q:
                                 sector(x4_q, y_q, coulG[q], eiqr[q], remat))
            del y
            return x_k, finish(gather_rows(wq_loc, dev_mesh, np.diff(qoff)))

        return state

    # ---- sector-chunked state: chunk sectors against a quarter of the
    # budget (y_c, its concatenation copy and its cotangent coexist), and
    # sweep the grid inside a chunk in blocks of 0.1 budget
    nq_all = len(qs_full)
    qchunk = nq_all
    if nq_all * per_sector_gb > budget / 4:
        qchunk = max(1, int((budget / 4) / per_sector_gb))
    blk = max(256, int(0.1 * budget * 1e9
                       / ((2 * nk + 2 * qchunk) * nip * cdt.itemsize)))
    blk = min(blk, ngrid)

    def block_rhs(c, positions, x_k, pcols):
        # checkpointed by the caller: the evaluator keeps its intermediates
        return _rhs_full(fn(c, positions, checkpoint=False), x_k, phase,
                         pcols)

    def chunk_wq(positions, x_k, x4_c, q0, q1):
        """The rank's sectors of the canonical positions q0:q1, x4_c their
        normal matrices (the chunk's exchange runs inside its checkpoint,
        on every rank alike)."""
        qs_np = qs_full[q0:q1]
        pcols = phase[:, torch.as_tensor(qs_np, device=device)]
        parts = []
        for g0 in range(0, len(coords_loc), blk):
            c = coords_loc[g0:g0 + blk]
            parts.append(_ckpt(block_rhs, c, positions, x_k, pcols)
                         if torch.is_grad_enabled()
                         else block_rhs(c, positions, x_k, pcols))
        y_c = torch.cat(parts, dim=1)                  # (nq_c, ng, nip)
        del parts
        return local(y_c, x4_c, qs_np, lambda x4_q, y_q, q: sector(
            x4_q, y_q, coulG[q], eiqr[q], True))[0]

    def state_chunked(positions):
        positions, x_k, x4_k = prologue(positions)
        pos_r, x_r, x4_r = (enter(t, dev_mesh)
                            for t in (positions, x_k, x4_k))
        parts, order = [], []
        for q0 in range(0, nq_all, qchunk):
            q1 = min(q0 + qchunk, nq_all)
            # the chunk's x4 rows are taken outside its checkpoint: their
            # gradient is then (nq_c, nip, nip), not nk x nip^2 a sector
            qs = torch.as_tensor(qs_full[q0:q1], device=device)
            args = (pos_r, x_r, x4_r[qs], q0, q1)
            if not torch.is_grad_enabled():
                parts.append(chunk_wq(*args))
            elif size == 1:
                parts.append(_ckpt(chunk_wq, *args))
            else:
                parts.append(_Recompute.apply(chunk_wq, *args))
            order.append(q0 + split(q1 - q0, size))
        # the ranks' sectors, rank-major, back into canonical order
        counts = [sum(int(o[r + 1] - o[r]) for o in order)
                  for r in range(size)]
        rank_major = np.concatenate([np.arange(o[r], o[r + 1])
                                     for r in range(size) for o in order])
        wq_sel = gather_rows(torch.cat(parts, dim=0), dev_mesh, counts)
        if size > 1:
            wq_sel = wq_sel[torch.as_tensor(np.argsort(rank_major),
                                            device=device)]
        return x_k, finish(wq_sel)

    state_chunked.nsectors = nq_all
    state_chunked.qchunk = qchunk
    state_chunked.blk = blk
    return state_chunked


def eri_grad_fn(cell, kpts, mask, kidx, kconserv2, m0=None, dtype=None,
                *, device="cuda", **state_kw):
    """d(ISDF ERI block)/d(positions): ``vg(positions, probe) -> (value,
    grad)`` of the real scalar Re sum(probe * eri) for a fixed probe
    tensor, eri the (k1, k2, k3, k4) block of ``kidx``."""
    device = resolve_device(device)
    rdt, cdt = real_complex(dtype)
    state = isdf_state_fn(cell, kpts, mask, m0=m0, dtype=rdt, device=device,
                          **state_kw)
    k1, k2, k3, k4 = kidx
    q = int(kconserv2[k1, k2])

    def vg(positions, probe):
        pos = torch.as_tensor(positions, dtype=rdt,
                              device=device).detach().requires_grad_(True)
        probe = torch.as_tensor(probe, dtype=cdt, device=device)
        with torch.enable_grad():
            x_k, wq = state(pos)
            eri = assemble_eri(wq[q], x_k[k1], x_k[k2], x_k[k3], x_k[k4])
            val = torch.sum(probe * eri).real
            (g,) = torch.autograd.grad(val, pos)
        return val.detach(), g

    return vg

