"""1-nearest-neighbor imputation of missing clinical values.

Port of the JAX package's ``models/knn_impute.py``. Reference:
``KNNImputer(missing_values=nan, n_neighbors=1)`` fit on the development
cohort (``train_ensemble_public.py:37-40``), with sklearn's semantics:

  * distances are ``nan_euclidean`` — squared distance over mutually present
    coordinates, rescaled by F / n_present (``ops.linalg.masked_pairwise_sq_dists``);
  * a donor for feature f must have f present;
  * with no eligible donor (or only NaN distances) the fit-column mean is used;
  * n_neighbors = 1 ⇒ the value of the single nearest donor, the first one
    (lowest donor index) among equally near donors.

``fit`` captures the donor matrix (capped at ``ImputerConfig.max_donors``
rows); ``transform`` runs the incomplete query rows in ``chunk_rows`` blocks
through an ``ImputeBlock`` specialised to the query's NaN pattern, as the
JAX ``_block_fn`` is.

Donor selection. The imputed value is a copied donor value, so the port must
pick the JAX package's donor. Every pattern takes the argmin form: one
shared ``torch.min`` over the distance rows for the donor-complete columns,
and one eligibility-masked ``torch.min`` per donor column that has NaN. Both
return the first minimal index, as documented. The JAX package switches to a
top-K scan above 16 masked donor columns and relies on ``lax.top_k`` ranking
ties by index; ``torch.topk`` promises no order among ties, on the CPU or on
CUDA, so the port does not use it: a top-K scan over its output could copy
another of several equally near donors' values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import ImputerConfig
from machine_learning_replications_tpu_torch.device import resolve_device, to_host
from machine_learning_replications_tpu_torch.ops.linalg import (
    masked_pairwise_sq_dists,
    masked_pairwise_sq_dists_dense_query,
)


@dataclasses.dataclass(frozen=True)
class KNNImputerParams:
    donors: torch.Tensor     # [n_fit, F] — the fit cohort, NaNs included
    col_means: torch.Tensor  # [F] — nan-mean fallback per column


def fit(
    X_fit: "np.ndarray | torch.Tensor",
    cfg: ImputerConfig = ImputerConfig(),
    seed: int = 2020,
    y: "np.ndarray | None" = None,
    *,
    device=None,
) -> KNNImputerParams:
    """Donors = the fit rows, capped at ``cfg.max_donors`` by a seeded
    subsample (label-stratified when ``y`` is given); column means from all
    fit rows. Tensors keep ``X_fit``'s dtype and land on ``device``."""
    dev = resolve_device(device)
    X_np = to_host(X_fit)
    donors = X_np
    if X_np.shape[0] > cfg.max_donors:
        if y is not None:
            from machine_learning_replications_tpu_torch.utils.cv import (
                stratified_subsample_indices,
            )

            keep = stratified_subsample_indices(np.asarray(y), cfg.max_donors, seed=seed)
        else:
            keep = np.sort(np.random.default_rng(seed).choice(
                X_np.shape[0], size=cfg.max_donors, replace=False))
        donors = X_np[keep]
    return KNNImputerParams(
        donors=torch.as_tensor(np.ascontiguousarray(donors), device=dev),
        col_means=torch.as_tensor(np.nanmean(X_np, axis=0), device=dev),
    )


@dataclasses.dataclass(frozen=True)
class ImputeBlock:
    """The imputation of one query block, specialised to a NaN pattern (the
    JAX ``_block_fn``'s static arguments):

      * only ``nan_cols`` (columns with a NaN in the query) get a pass; the
        others are copied through;
      * the donor-complete columns among them share one nearest donor;
        each of ``masked_donor_cols`` (the donor column has NaN) gets its own
        eligibility-masked pass;
      * ``dist_cols``, set when every NaN column is fully missing in the
        query (the contract-row shape), restricts the distances to the
        complement columns through the dense-query form — the same
        restriction the JAX package makes, so the same distances are
        compared;
      * ``dist_index`` and ``nan_index``, set by ``on_device``, hold
        ``dist_cols`` and ``nan_cols`` as index tensors on the card, so a
        call uploads nothing (a CUDA-graph capture may not copy from host
        memory).

    The NaN columns are gathered, selected and written back as one block
    (one op each, whatever their number); only the masked donor columns
    take a pass each. Every step is a selection, so the values are those of
    a column-by-column pass.
    """

    nan_cols: tuple[int, ...]
    masked_donor_cols: tuple[int, ...]
    dist_cols: "tuple[int, ...] | None" = None
    dist_index: "torch.Tensor | None" = dataclasses.field(default=None, compare=False,
                                                          repr=False)
    nan_index: "torch.Tensor | None" = dataclasses.field(default=None, compare=False,
                                                         repr=False)

    def on_device(self, device: torch.device) -> "ImputeBlock":
        """This block with its distance and NaN columns resident on
        ``device``."""
        return dataclasses.replace(
            self,
            dist_index=(None if self.dist_cols is None
                        else torch.as_tensor(self.dist_cols, device=device)),
            nan_index=torch.as_tensor(self.nan_cols, dtype=torch.long, device=device))

    @staticmethod
    def _index(resident, cols, device) -> torch.Tensor:
        if resident is None or resident.device != device:
            return torch.as_tensor(cols, dtype=torch.long, device=device)
        return resident

    def distances(self, params: KNNImputerParams, X: torch.Tensor) -> torch.Tensor:
        """``[nq, n_fit]`` squared nan-euclidean distances, NaN → +inf."""
        if self.dist_cols is None:
            D = masked_pairwise_sq_dists(X, params.donors)
        else:
            cols = self._index(self.dist_index, self.dist_cols, X.device)
            D = masked_pairwise_sq_dists_dense_query(X.index_select(1, cols),
                                                     params.donors.index_select(1, cols))
        return torch.where(torch.isnan(D), torch.inf, D)

    def donors(self, params: KNNImputerParams, X: torch.Tensor):
        """``(idx, ok)``, each ``[nq, len(nan_cols)]``: per NaN column the
        first nearest eligible donor, and whether one exists at a finite
        distance."""
        D = self.distances(params, X)
        first = torch.arange(D.shape[1], device=D.device)
        shared, shared_idx = _first_min(D, first)
        k = len(self.nan_cols)
        idx = shared_idx[:, None].repeat(1, k)
        ok = torch.isfinite(shared)[:, None].repeat(1, k)
        for pos, fcol in enumerate(self.nan_cols):
            if fcol in self.masked_donor_cols:
                has = ~torch.isnan(params.donors[:, fcol])
                best, best_idx = _first_min(D.masked_fill(~has[None, :], torch.inf), first)
                idx[:, pos] = best_idx
                ok[:, pos] = torch.isfinite(best)
        return idx, ok

    def __call__(self, params: KNNImputerParams, X: torch.Tensor) -> torch.Tensor:
        if not self.nan_cols:
            return X.clone()
        idx, ok = self.donors(params, X)
        cols = self._index(self.nan_index, self.nan_cols, X.device)
        donated = torch.where(ok, params.donors[idx, cols[None, :]],
                              params.col_means.index_select(0, cols)[None, :]).to(X.dtype)
        held = X.index_select(1, cols)
        return X.index_copy(1, cols, torch.where(torch.isnan(held), donated, held))


def _first_min(D: torch.Tensor, cols: torch.Tensor):
    """``(values, indices)`` of each row's minimum, the index the first
    minimal one (``torch.min(dim=1)``'s), as two plain reductions: a
    compiler lowers them to far less code than a paired value-index
    reduction."""
    values = torch.amin(D, dim=1)
    return values, torch.where(D == values[:, None], cols, D.shape[1]).amin(dim=1)


def donor_nan_columns(params: KNNImputerParams) -> np.ndarray:
    """``[F]`` host flags: which donor columns hold a NaN (one device
    reduction and a fetch)."""
    return to_host(torch.isnan(params.donors).any(dim=0))


def resolve_block_fn(params: KNNImputerParams, X: "np.ndarray | torch.Tensor",
                     donor_nan: "np.ndarray | None" = None) -> ImputeBlock:
    """The ``ImputeBlock`` for ``X``'s NaN pattern: NaN columns from the
    query, the masked subset from the donors (``donor_nan_columns``, unless
    the caller passes those flags, fetched once), and the ``dist_cols``
    restriction when every NaN column is fully missing. For callers whose
    pattern is fixed across many ``transform`` calls, resolve once and pass
    it back as ``block_fn``."""
    isnan = np.isnan(to_host(X))
    nan_cols = tuple(int(c) for c in np.flatnonzero(isnan.any(axis=0)))
    if donor_nan is None:
        donor_nan = donor_nan_columns(params)
    masked = tuple(c for c in nan_cols if donor_nan[c])
    dist_cols = None
    if nan_cols and bool(isnan[:, list(nan_cols)].all()):
        complement = tuple(c for c in range(isnan.shape[1]) if c not in set(nan_cols))
        if complement:  # degenerate all-NaN queries keep the full form
            dist_cols = complement
    return ImputeBlock(nan_cols, masked, dist_cols)


def transform(
    params: KNNImputerParams,
    X: "np.ndarray | torch.Tensor",
    chunk_rows: int | None = None,
    block_fn: ImputeBlock | None = None,
    mesh=None,
) -> torch.Tensor:
    """Impute ``X [n, F]`` → a tensor on the donors' device, in the dtype of
    ``X`` and the donors promoted together.

    Complete rows are fixed points and pass through untouched; only the
    incomplete rows go through ``block_fn`` (resolved from them unless
    given — a pre-resolved block is valid whenever its pattern
    column-matches theirs), in blocks of ``chunk_rows`` (default
    ``ImputerConfig().chunk_rows``) so a block's ``[chunk, n_fit]`` distance
    matrix stays bounded.

    With ``mesh`` (``parallel.make_mesh``), the incomplete rows are sharded
    over its 'data' axis (``parallel.rowwise.apply_rows_sharded``): a row's
    imputation depends only on the donors, which every rank holds, and
    every rank gets the whole output."""
    chunk = ImputerConfig().chunk_rows if chunk_rows is None else chunk_rows
    X_np = to_host(X)
    dtype = torch.promote_types(torch.as_tensor(X_np[:0]).dtype, params.donors.dtype)
    # a copy: on the CPU ``as_tensor`` would share the caller's array
    out = torch.as_tensor(X_np, device=params.donors.device).to(dtype, copy=True)
    rows = np.flatnonzero(np.isnan(X_np).any(axis=1))
    if rows.size == 0:
        return out
    if block_fn is None:
        block_fn = resolve_block_fn(params, X_np[rows])
    if mesh is not None:
        from machine_learning_replications_tpu_torch.parallel.rowwise import apply_rows_sharded

        # NaN pad rows impute to column means and are sliced off.
        idx = torch.as_tensor(rows, device=out.device)
        out[idx] = apply_rows_sharded(mesh, block_fn, params, out[idx], chunk_rows=chunk,
                                      pad_value=np.nan)
        return out
    return impute_rows(params, out, torch.as_tensor(rows, device=out.device), block_fn, chunk)


def impute_rows(params: KNNImputerParams, out: torch.Tensor, rows: torch.Tensor,
                block_fn: ImputeBlock, chunk_rows: int | None = None) -> torch.Tensor:
    """``transform``'s device half: impute the rows ``rows`` (an index
    tensor on ``out``'s device) of ``out`` in place through ``block_fn``,
    in blocks of ``chunk_rows``; returns ``out``. Nothing here reads host
    memory or waits for the card, so a caller that keeps ``out`` and
    ``rows`` on the card (the bulk scorer's device stage) queues it
    without a sync."""
    chunk = ImputerConfig().chunk_rows if chunk_rows is None else chunk_rows
    for s in range(0, int(rows.shape[0]), chunk):
        r = rows[s:s + chunk]
        out[r] = block_fn(params, out[r])
    return out


def fit_transform(
    X_fit: "np.ndarray | torch.Tensor",
    cfg: ImputerConfig = ImputerConfig(),
    seed: int = 2020,
    y: "np.ndarray | None" = None,
    *,
    mesh=None,
    device=None,
) -> tuple[KNNImputerParams, torch.Tensor]:
    params = fit(X_fit, cfg, seed, y=y, device=device)
    return params, transform(params, X_fit, cfg.chunk_rows, mesh=mesh)
