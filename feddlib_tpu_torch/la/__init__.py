from feddlib_tpu_torch.la.map import IndexMap
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector

__all__ = ["IndexMap", "CsrMatrix", "SparsityPattern", "BlockMatrix", "BlockVector"]
