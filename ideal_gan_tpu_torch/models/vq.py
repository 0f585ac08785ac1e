"""Vector quantizer (port of `ideal_gan_tpu/models/vq.py`).

Nearest code by ‖x‖² − 2·x·W + ‖w‖² over the codebook W (D, K), the
straight-through estimator, the loss q + β·e (codebook and commitment
terms) and the codebook perplexity. The JAX module sows the loss and the
perplexity into Flax collections; this one returns them. On a data mesh
(`mesh=`) the perplexity is the global batch's: the code frequencies are
averaged over the ranks first.
"""

from __future__ import annotations

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    def __init__(self, embedding_dim: int, num_embeddings: int,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(torch.empty(embedding_dim,
                                                 num_embeddings))

    def _indices(self, flat: torch.Tensor) -> torch.Tensor:
        cb = self.codebook
        dists = (torch.sum(flat ** 2, dim=1, keepdim=True)
                 - 2.0 * flat @ cb + torch.sum(cb ** 2, dim=0, keepdim=True))
        return torch.argmin(dists, dim=1)

    def forward(self, x, mesh=None):
        """x (..., D) → (the straight-through quantized x, vq_loss,
        perplexity)."""
        from ..parallel.mesh import mean_over_ranks
        flat = x.reshape(-1, self.embedding_dim)
        idx = self._indices(flat)
        onehot = nn.functional.one_hot(idx, self.num_embeddings).to(x.dtype)
        quantized = (onehot @ self.codebook.T).reshape(x.shape)
        e_latent = torch.mean(torch.square(quantized.detach() - x))
        q_latent = torch.mean(torch.square(quantized - x.detach()))
        loss = q_latent + self.commitment_cost * e_latent
        avg_probs = mean_over_ranks(torch.mean(onehot, dim=0), mesh)
        perplexity = torch.exp(-torch.sum(avg_probs
                                          * torch.log(avg_probs + 1e-10)))
        return x + (quantized - x).detach(), loss, perplexity

    def quantize_indices(self, x: torch.Tensor) -> torch.Tensor:
        """Hard codebook indices of a latent grid (..., D) → (...)."""
        with torch.no_grad():
            flat = x.reshape(-1, self.embedding_dim)
            return self._indices(flat).reshape(x.shape[:-1])

    def init_params(self, generator: torch.Generator) -> None:
        """Flax's variance_scaling(1, fan_in, uniform): U(±√(3/D))."""
        bound = (3.0 / self.embedding_dim) ** 0.5
        with torch.no_grad():
            nn.init.uniform_(self.codebook, -bound, bound,
                             generator=generator)
