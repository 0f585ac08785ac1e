"""Plain training steps of the two trainers the benchmark drives, and the
replay of their feed.

- `vetnet_loss`: TE-augmentation training (`train-IDEAL-TEaug.py`): the
  acquisitions of the ground-truth maps B at the batch's TE train plus
  `noise_std` times standard normal noise, VET-Net's (phi, R2*) masked to
  B's support, the mean absolute error to B's maps.
- `cycle_loss`: AI-DEAL (`train-IDEAL-unsup.py`, out_vars PM): the field
  map net on the echoes, the R2* net on their magnitudes, the IDEAL cycle
  A_hat masked to the echoes' support, mean((A - A_hat)^2); the FM step
  trains the field-map net with the R2* net frozen, the R2 step the
  other way round.
- `Adam`: optax's chain(clip_by_global_norm(c), adam(lr, b1, b2)), eps
  1e-8, the clip dividing by the norm itself.
- `replay_feed`: the trainer loop body's batches: a shuffled epoch order
  from a numpy generator, per batch a uniform draw against the
  augmentation probability, then a 90-degree rotation (k in {0, 1, 2})
  and two flips drawn from a torch generator, then, for TE augmentation,
  one TE train from the same generator.
"""

from __future__ import annotations

import numpy as np
import torch

from . import physics


def vetnet_loss(net, B, te, noise, noise_std, field):
    """(the loss, the net's output)."""
    A = physics.synthesize(B[:, :3], te, field) + noise_std * noise
    out = net(A, te[..., 0])
    b_pm = B[:, 2:3]
    pm = torch.where(b_pm != 0.0, out, torch.zeros_like(out))
    return torch.mean(torch.abs(b_pm - pm)), out


def cycle_loss(g_fm, g_r2, A, te, field, train: str):
    """The FM step's loss (train="fm") or the R2 step's (train="r2"), and
    the nets' outputs {"g_fm", "g_r2"}."""
    with torch.set_grad_enabled(train == "fm"):
        fm = g_fm(A)
    a_abs = torch.sqrt(torch.sum(torch.square(A), dim=-1, keepdim=True))
    with torch.set_grad_enabled(train == "r2"):
        r2 = g_r2(a_abs)
    a_hat = physics.cycle(A, torch.cat([fm, r2], dim=-1), te, field)
    a_hat = torch.where(A != 0.0, a_hat, torch.zeros_like(a_hat))
    return torch.mean(torch.square(A - a_hat)), {"g_fm": fm, "g_r2": r2}


class Adam:
    def __init__(self, params, lr, beta_1, beta_2, clip=None, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2 = lr, beta_1, beta_2
        self.clip, self.eps, self.count = clip, eps, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        """Returns the gradients as the update received them (clipped)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.clip:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if norm >= self.clip:
                grads = [g / norm * self.clip for g in grads]
        self.count += 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1 = float(np.float32(1) - b1 ** np.float32(self.count))
        bc2 = float(np.float32(1) - b2 ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_((m / bc1) / ((v / bc2).sqrt() + self.eps) * self.lr)
            p.grad = None
        return grads


def geometric(gen: torch.Generator, x: np.ndarray) -> np.ndarray:
    k = int(torch.randint(0, 3, (), generator=gen))
    flip_lr, flip_ud = (torch.rand(2, generator=gen) < 0.5).tolist()
    x = np.rot90(x, k, axes=(2, 3))
    if flip_lr:
        x = x[:, :, :, ::-1]
    if flip_ud:
        x = x[:, :, ::-1]
    return np.ascontiguousarray(x)


def sample_te(gen: torch.Generator, ne: int, bs: int, te1, dte,
              jitter) -> np.ndarray:
    """One TE train (bs, ne, 1): TE1 ~ U(te1), a common spacing ~ U(dte),
    each spacing ~ N(common, jitter^2), in double precision."""
    u = torch.rand(2, generator=gen, dtype=torch.float64)
    t1 = te1[0] + u[0] * (te1[1] - te1[0])
    d = dte[0] + u[1] * (dte[1] - dte[0])
    d = d + jitter * torch.randn(ne - 1, generator=gen, dtype=torch.float64)
    te = t1 + torch.cat([torch.zeros(1, dtype=torch.float64),
                         torch.cumsum(d, 0)])
    return np.repeat(te.float().numpy()[None, :, None], bs, axis=0)


def replay_feed(arrays, batch_size: int, n_batches: int, np_seed: int,
                torch_seed: int, aug_p: float, te_sampler=None):
    """The first `n_batches` batches of the loop body: tuples of the
    arrays' rows (the first one augmented), plus the sampled TE train
    where `te_sampler` (dict te1, dte, jitter, ne) is given."""
    rng = np.random.default_rng(np_seed)
    gen = torch.Generator().manual_seed(torch_seed)
    n = len(arrays[0])
    out = []
    while len(out) < n_batches:
        idx = rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            rows = [a[idx[i:i + batch_size]] for a in arrays]
            if rng.random() <= aug_p:
                rows[0] = geometric(gen, rows[0])
            if te_sampler is not None:
                rows.append(sample_te(gen, te_sampler["ne"], batch_size,
                                      te_sampler["te1"], te_sampler["dte"],
                                      te_sampler["jitter"]))
            out.append(tuple(rows))
            if len(out) == n_batches:
                break
    return out
