"""I/O layer: the matrix formats of the reference (c++/io.cpp), through
the native C++ library where it builds (:mod:`bpmf_tpu_torch.io.native`)
and pure Python otherwise (copy of ``bpmf_tpu.io``)."""

from bpmf_tpu_torch.io.matrix_io import (  # noqa: F401
    read_dense,
    read_matrix,
    read_sparse,
    write_matrix,
)
