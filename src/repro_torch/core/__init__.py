"""Core of the port: index, engine, pruners, solvers, sparse containers."""
from .index import append_docs
from .sinkhorn import LamUnderflowError, select_support
from .sparse import PaddedDocs, padded_docs_to_dense
from .wmd import IMPLS, many_to_many, one_to_many, search

__all__ = ["IMPLS", "LamUnderflowError", "PaddedDocs", "append_docs",
           "many_to_many", "one_to_many", "padded_docs_to_dense", "search",
           "select_support"]
