"""Sparse NDArrays: CSR and row_sparse (counterpart of
``mxnet_tpu/ndarray/sparse.py``).

As the reference's, a sparse array keeps the sparse *metadata* (the
``indptr``/``indices``/``data`` views and its ``stype``) and computes
densely: it is an :class:`NDArray` over the dense tensor, so every op
takes it as an operand, and ``.params`` files store it dense.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import current_context
from .ndarray import NDArray, array as nd_array

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix", "row_sparse_array",
           "BaseSparseNDArray"]


class BaseSparseNDArray(NDArray):
    @property
    def stype(self):
        raise NotImplementedError

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data, ctx=self._ctx)
        if stype == self.stype:
            return self
        if stype == "row_sparse":
            return RowSparseNDArray.from_dense(NDArray(self._data,
                                                       ctx=self._ctx))
        if stype == "csr":
            return CSRNDArray.from_dense(NDArray(self._data, ctx=self._ctx))
        raise ValueError(f"unknown stype {stype!r}")

    def todense(self) -> NDArray:
        return NDArray(self._data, ctx=self._ctx)

    def asscipy(self):
        raise NotImplementedError("scipy interchange not available")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (2D)."""

    def __init__(self, dense_data, indptr, indices, sdata, ctx=None):
        super().__init__(dense_data, ctx=ctx)
        self._indptr = indptr
        self._indices = indices
        self._sdata = sdata

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return nd_array(self._indptr, ctx=self.context)

    @property
    def indices(self) -> NDArray:
        return nd_array(self._indices, ctx=self.context)

    @property
    def data(self) -> NDArray:
        return nd_array(self._sdata, ctx=self.context)

    @staticmethod
    def from_dense(arr: NDArray) -> "CSRNDArray":
        d = np.asarray(arr.asnumpy())
        assert d.ndim == 2, "CSR requires 2D"
        rows, cols = np.nonzero(d)
        indptr = np.zeros(d.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=d.shape[0]), out=indptr[1:])
        return CSRNDArray(arr._data, indptr, cols.astype(np.int64),
                          d[rows, cols], ctx=arr.context)

    def __repr__(self):
        return (f"<CSRNDArray {self.shape} nnz={len(self._sdata)} "
                f"@{self.context}>")


class RowSparseNDArray(BaseSparseNDArray):
    """First-dim sparse tensor: (indices, data[rows]) — the embedding
    gradient's format."""

    def __init__(self, dense_data, indices, sdata, ctx=None):
        super().__init__(dense_data, ctx=ctx)
        self._indices = indices
        self._sdata = sdata

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return nd_array(self._indices, ctx=self.context)

    @property
    def data(self) -> NDArray:
        return nd_array(self._sdata, ctx=self.context)

    @staticmethod
    def from_dense(arr: NDArray) -> "RowSparseNDArray":
        d = np.asarray(arr.asnumpy())
        nz_rows = np.nonzero(d.reshape(d.shape[0], -1).any(axis=1))[0]
        return RowSparseNDArray(arr._data, nz_rows.astype(np.int64),
                                d[nz_rows], ctx=arr.context)

    def retain(self, rs_indices) -> "RowSparseNDArray":
        """The rows named in ``rs_indices`` kept, every other row zero."""
        keep = np.asarray(
            rs_indices.asnumpy() if isinstance(rs_indices, NDArray)
            else rs_indices).astype(np.int64).reshape(-1)
        mask = torch.zeros(self.shape[0], dtype=torch.bool,
                           device=self._data.device)
        mask[torch.from_numpy(keep[(keep >= 0) & (keep < self.shape[0])])
             .to(self._data.device)] = True
        shape = (-1,) + (1,) * (self._data.dim() - 1)
        kept = torch.where(mask.reshape(shape), self._data,
                           torch.zeros((), dtype=self._data.dtype,
                                       device=self._data.device))
        return RowSparseNDArray.from_dense(NDArray(kept, ctx=self.context))

    def __repr__(self):
        return (f"<RowSparseNDArray {self.shape} rows={len(self._indices)} "
                f"@{self.context}>")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """csr_matrix((data, indices, indptr), shape=...) or from a dense
    source."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = np.asarray(data, dtype or np.float32)
        indices = np.asarray(indices, np.int64)
        indptr = np.asarray(indptr, np.int64)
        n_rows = len(indptr) - 1
        n_cols = shape[1] if shape else (int(indices.max()) + 1
                                         if len(indices) else 0)
        dense = np.zeros((n_rows, n_cols), data.dtype)
        rows = np.repeat(np.arange(n_rows), np.diff(indptr))
        dense[rows, indices] = data
        ctx = ctx or current_context()
        return CSRNDArray(NDArray(dense, ctx=ctx)._data, indptr, indices,
                          data, ctx=ctx)
    return CSRNDArray.from_dense(nd_array(arg1, ctx=ctx, dtype=dtype))


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """row_sparse_array((data, indices), shape=...) or from a dense
    source."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = np.asarray(data, dtype or np.float32)
        indices = np.asarray(indices, np.int64)
        n_rows = shape[0] if shape else int(indices.max()) + 1
        dense = np.zeros((n_rows,) + data.shape[1:], data.dtype)
        dense[indices] = data
        ctx = ctx or current_context()
        return RowSparseNDArray(NDArray(dense, ctx=ctx)._data, indices,
                                data, ctx=ctx)
    return RowSparseNDArray.from_dense(nd_array(arg1, ctx=ctx, dtype=dtype))
