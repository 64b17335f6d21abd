"""Pairwise similarity and distance functionals (port of
``metrics_tpu/functional/pairwise``; a functional-only domain, no modules)."""

from metrics_tpu_torch.functional.pairwise.similarity import (
    pairwise_cosine_similarity,
    pairwise_euclidean_distance,
    pairwise_linear_similarity,
    pairwise_manhattan_distance,
)

__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
]
