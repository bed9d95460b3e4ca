"""Dense tensors + sparse formats (COO/CSR/CSF-lite).

Reference: cpp/src/arrow/tensor*.{h,cc} + arrow/tensor/ — dense Tensor
with strides, SparseCOOTensor/SparseCSRMatrix/SparseCSFTensor and
conversions. device redesign: a dense Tensor is just a device array + dim
names (strides are XLA's concern); sparse formats keep the reference's
index layouts as device arrays so they convert zero-copy to/from
pyarrow's sparse tensors at the host boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .errors import Invalid

__all__ = ["Tensor", "SparseCOOTensor", "SparseCSRMatrix",
           "SparseCSFTensor"]


@jax.tree_util.register_pytree_node_class
class Tensor:
    """Dense n-dim tensor (reference: arrow/tensor.h Tensor)."""

    __slots__ = ("data", "dim_names")

    def __init__(self, data, dim_names: Optional[Sequence[str]] = None):
        self.data = data
        self.dim_names = tuple(dim_names) if dim_names else None

    def tree_flatten(self):
        return (self.data,), (self.dim_names,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return int(np.prod(self.data.shape))

    def to_numpy(self):
        return np.asarray(self.data)

    def to_arrow(self):
        import pyarrow as pa

        return pa.Tensor.from_numpy(self.to_numpy(),
                                    dim_names=self.dim_names)

    @classmethod
    def from_arrow(cls, t) -> "Tensor":
        names = list(t.dim_names) if t.dim_names else None
        return cls(jnp.asarray(t.to_numpy()), names)

    def to_coo(self) -> "SparseCOOTensor":
        """Dense -> COO (host-syncs nnz, like the eager two-phase ops)."""
        nz = self.data != 0
        nnz = int(jnp.sum(nz))
        flat_idx = jnp.nonzero(nz.ravel(), size=nnz, fill_value=0)[0]
        coords = jnp.stack(jnp.unravel_index(flat_idx, self.data.shape),
                           axis=1).astype(jnp.int64)
        values = self.data.ravel()[flat_idx]
        return SparseCOOTensor(coords, values, self.shape, self.dim_names)

    def __repr__(self):
        return f"Tensor{self.shape} {self.data.dtype}"


@jax.tree_util.register_pytree_node_class
class SparseCOOTensor:
    """COO: [nnz, ndim] coordinates + values (reference:
    arrow/sparse_tensor.h SparseCOOIndex)."""

    __slots__ = ("coords", "values", "shape", "dim_names")

    def __init__(self, coords, values, shape, dim_names=None):
        self.coords = coords
        self.values = values
        self.shape = tuple(shape)
        self.dim_names = tuple(dim_names) if dim_names else None

    def tree_flatten(self):
        return (self.coords, self.values), (self.shape, self.dim_names)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])

    @property
    def non_zero_length(self):
        return int(self.values.shape[0])

    def to_dense(self) -> Tensor:
        out = jnp.zeros(self.shape, self.values.dtype)
        out = out.at[tuple(self.coords[:, i] for i in range(len(self.shape)))
                     ].set(self.values)
        return Tensor(out, self.dim_names)

    def to_csf(self) -> "SparseCSFTensor":
        return SparseCSFTensor.from_coo(self)

    def to_csr(self) -> "SparseCSRMatrix":
        if len(self.shape) != 2:
            raise Invalid("CSR requires a 2-D tensor")
        rows = self.coords[:, 0]
        cols = self.coords[:, 1]
        order = jnp.argsort(rows * self.shape[1] + cols, stable=True)
        rows, cols = rows[order], cols[order]
        values = self.values[order]
        indptr = jnp.searchsorted(
            rows, jnp.arange(self.shape[0] + 1, dtype=rows.dtype))
        return SparseCSRMatrix(indptr, cols, values, self.shape,
                               self.dim_names)

    def to_arrow(self):
        import pyarrow as pa

        return pa.SparseCOOTensor.from_numpy(
            np.asarray(self.values), np.asarray(self.coords),
            self.shape, dim_names=self.dim_names)

    @classmethod
    def from_arrow(cls, t) -> "SparseCOOTensor":
        values, coords = t.to_numpy()
        return cls(jnp.asarray(coords), jnp.asarray(values.ravel()),
                   t.shape, list(t.dim_names) if t.dim_names else None)


@jax.tree_util.register_pytree_node_class
class SparseCSRMatrix:
    """CSR: indptr[rows+1] + col indices + values (reference:
    arrow/sparse_tensor.h SparseCSRIndex)."""

    __slots__ = ("indptr", "indices", "values", "shape", "dim_names")

    def __init__(self, indptr, indices, values, shape, dim_names=None):
        self.indptr = indptr
        self.indices = indices
        self.values = values
        self.shape = tuple(shape)
        self.dim_names = tuple(dim_names) if dim_names else None

    def tree_flatten(self):
        return (self.indptr, self.indices, self.values), (self.shape,
                                                          self.dim_names)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])

    @property
    def non_zero_length(self):
        return int(self.values.shape[0])

    def to_dense(self) -> Tensor:
        nnz = self.values.shape[0]
        lengths = self.indptr[1:] - self.indptr[:-1]
        rows = jnp.repeat(jnp.arange(self.shape[0]), lengths,
                          total_repeat_length=nnz)
        out = jnp.zeros(self.shape, self.values.dtype)
        out = out.at[rows, self.indices].set(self.values)
        return Tensor(out, self.dim_names)

    def matvec(self, x) -> jnp.ndarray:
        """SpMV via segment-sum — the device-native sparse kernel shape."""
        nnz = self.values.shape[0]
        lengths = self.indptr[1:] - self.indptr[:-1]
        rows = jnp.repeat(jnp.arange(self.shape[0]), lengths,
                          total_repeat_length=nnz)
        prod = self.values * x[self.indices]
        return jnp.zeros(self.shape[0], prod.dtype).at[rows].add(prod)

    def to_arrow(self):
        import pyarrow as pa

        return pa.SparseCSRMatrix.from_numpy(
            np.asarray(self.values), np.asarray(self.indptr),
            np.asarray(self.indices), self.shape, dim_names=self.dim_names)


@jax.tree_util.register_pytree_node_class
class SparseCSFTensor:
    """CSF: compressed sparse fiber for n-dim tensors (reference:
    arrow/sparse_tensor.h SparseCSFIndex — a prefix tree over sorted
    coordinates; indptr[k] maps level-k nodes to their level-k+1 child
    ranges, indices[k] holds each node's coordinate along axis k).

    ``indices`` has one array per dimension (the last is nnz long);
    ``indptr`` has ndim-1 arrays. Values are sorted lexicographically by
    coordinate, matching pyarrow's SparseCSFTensor byte layout exactly.
    """

    __slots__ = ("indptr", "indices", "values", "shape", "axis_order",
                 "dim_names")

    def __init__(self, indptr, indices, values, shape, axis_order=None,
                 dim_names=None):
        self.indptr = tuple(indptr)
        self.indices = tuple(indices)
        self.values = values
        self.shape = tuple(shape)
        self.axis_order = (tuple(axis_order) if axis_order is not None
                           else tuple(range(len(self.shape))))
        self.dim_names = tuple(dim_names) if dim_names else None

    def tree_flatten(self):
        return ((self.indptr, self.indices, self.values),
                (self.shape, self.axis_order, self.dim_names))

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, indices, values = children
        return cls(indptr, indices, values, aux[0], aux[1], aux[2])

    @property
    def non_zero_length(self):
        return int(self.values.shape[0])

    @classmethod
    def from_coo(cls, coo: "SparseCOOTensor") -> "SparseCSFTensor":
        """Build the prefix tree from COO coordinates (host-side lexsort —
        format conversion is boundary work, like to_arrow)."""
        coords = np.asarray(coo.coords)
        vals = np.asarray(coo.values)
        nnz, n = coords.shape
        # smaller axes toward the root maximize prefix sharing — the same
        # heuristic the reference converter uses (tensor/csf_converter.cc)
        axis_order = np.argsort(np.asarray(coo.shape), kind="stable")
        coords = coords[:, axis_order]
        order = np.lexsort(coords.T[::-1])  # lexicographic, level 0 major
        coords, vals = coords[order], vals[order]
        indptr, indices = [], []
        # starts of unique prefixes per level (with nnz sentinel)
        prev_starts = None
        for k in range(n):
            if nnz == 0:
                starts = np.array([0], dtype=np.int64)
            else:
                prefix = coords[:, :k + 1]
                is_new = np.ones(nnz, dtype=bool)
                is_new[1:] = (prefix[1:] != prefix[:-1]).any(axis=1)
                starts = np.flatnonzero(is_new)
            indices.append(jnp.asarray(coords[starts, k]
                                       if nnz else np.array([], np.int64)))
            if k > 0:
                # parent node i covers child nodes whose start falls in
                # [prev_starts[i], prev_starts[i+1])
                bounds = np.concatenate([prev_starts, [nnz]])
                indptr.append(jnp.asarray(
                    np.searchsorted(starts, bounds).astype(np.int64)))
            prev_starts = starts
        return cls(indptr, indices, jnp.asarray(vals), coo.shape,
                   axis_order.tolist(), coo.dim_names)

    def _expand_coords(self):
        """Walk the tree back to [nnz, ndim] coordinates (host)."""
        n = len(self.shape)
        node_coords = [np.asarray(self.indices[0])]  # level 0 partial rows
        for k in range(1, n):
            ptr = np.asarray(self.indptr[k - 1])
            counts = ptr[1:] - ptr[:-1]
            parent = np.repeat(np.arange(len(counts)), counts)
            prev = node_coords[-1]
            prev_rows = prev[parent] if prev.ndim == 1 else prev[parent, :]
            node_coords.append(np.column_stack(
                [prev_rows, np.asarray(self.indices[k])]))
        perm = node_coords[-1].reshape(-1, n)
        out = np.empty_like(perm)
        out[:, list(self.axis_order)] = perm  # level k is axis_order[k]
        return out

    def to_coo(self) -> "SparseCOOTensor":
        return SparseCOOTensor(jnp.asarray(self._expand_coords()),
                               self.values, self.shape, self.dim_names)

    def to_dense(self) -> Tensor:
        coords = jnp.asarray(self._expand_coords())
        out = jnp.zeros(self.shape, self.values.dtype)
        out = out.at[tuple(coords[:, i] for i in range(len(self.shape)))
                     ].set(self.values)
        return Tensor(out, self.dim_names)

    def to_arrow(self):
        import pyarrow as pa

        return pa.SparseCSFTensor.from_numpy(
            np.asarray(self.values),
            [np.asarray(p) for p in self.indptr],
            [np.asarray(i) for i in self.indices],
            self.shape, axis_order=list(self.axis_order),
            dim_names=self.dim_names)

    @classmethod
    def from_arrow(cls, t) -> "SparseCSFTensor":
        # pyarrow does not expose the stored axis_order, so rebuild the
        # tree from the dense view (canonical ascending-size order)
        dense = Tensor(jnp.asarray(t.to_tensor().to_numpy()),
                       list(t.dim_names) if t.dim_names else None)
        return dense.to_coo().to_csf()

    def __repr__(self):
        return f"SparseCSFTensor{self.shape} nnz={self.non_zero_length}"
