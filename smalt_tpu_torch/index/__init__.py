from .table import KmerIndex, build_index
