"""Block-sparse substrate (block-ELL) of the port."""

from repro_torch.sparse.blocksparse import (
    BlockELL,
    block_ell_to_dense,
    dense_to_block_ell,
)

__all__ = ["BlockELL", "block_ell_to_dense", "dense_to_block_ell"]
