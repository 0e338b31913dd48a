"""The plain reference of a densification round and of the opacity reset.

Written from RAIN-GS's scene/gaussian_model.py:319-421 (the 3DGS engine
with the abe_split pre-pass) on dynamic tensors, as that code keeps its
Gaussians: every step below concatenates or drops rows.

- Statistics: the mean screen-space gradient accum / denom, 0 where denom
  is 0 (:405-406).
- Clone (:388-401): mean gradient ≥ ``max_grad`` and largest scale ≤
  ``percent_dense``·extent; the rows copied verbatim to the end.
- The abe_split pre-pass (:342-363), with ``abe_split``: the rows of
  mean gradient ≥ ``max_grad`` and largest scale > ``percent_dense``·
  extent among the rows before the clones (the clones' gradients are the
  zero padding of :344-345), one copy each appended with its position
  multiplied by 0.3·extent and everything else unchanged.
- Split (:366-386): the same rows (the copies' gradients are padding
  again), ``n_split`` children each at position + R(q)·(noise·scale) and
  scale / (``divide_ratio``·n_split); the parents are dropped.
- Prune (:410-415): opacity below ``min_opacity`` and, with a
  ``max_screen_size``, a screen radius above it or a largest scale above
  0.1·extent.
- Adam: appended rows start with zero moments (cat_tensors_to_optimizer,
  :294-317), dropped rows take theirs with them (_prune_optimizer,
  :248-270); the statistics restart at zero (densification_postfix,
  :319-337).
- The opacity reset (:200-203): logit(min(sigmoid(o), 0.01)).

Departures, each written down:

- The split noise is an argument, [n_split, n, 3], and child s of row i
  takes noise[s, i], as the program takes it: torch cannot reproduce the
  reference's draw (``torch.normal`` inside the round).
- The screen radius the size test reads is each row's from before the
  round (0 for appended rows), as rain_tpu and the program read it: the
  INRIA code zeros ``max_radii2D`` in densification_postfix before its
  prune reads it, so its screen test never fires.
- A split parent's children sit next to each other (parent r's child s
  at 2r + s among the children), rain_tpu's and the program's order; the
  INRIA code's ``repeat(N, 1)`` puts every first child before every
  second. The order changes no value.

Everything runs in the dtype of the tensors it is given (float32 for the
reference, bfloat16 for the control).
"""

from __future__ import annotations

import torch

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
STATS = ("max_radii2d", "xyz_gradient_accum", "denom")


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[M, 3, 3] of the normalised quaternions (utils/general_utils.py:
    52-73)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


class Gaussians:
    """Rows of parameters with their Adam moments and screen radii."""

    def __init__(self, params: dict, mu: dict, nu: dict,
                 radii: torch.Tensor):
        self.params, self.mu, self.nu, self.radii = params, mu, nu, radii

    def __len__(self) -> int:
        return self.params["xyz"].shape[0]

    def append(self, new: dict) -> None:
        """cat_tensors_to_optimizer: new rows with zero moments."""
        for k in LEAVES:
            self.params[k] = torch.cat([self.params[k], new[k]])
            self.mu[k] = torch.cat([self.mu[k], torch.zeros_like(new[k])])
            self.nu[k] = torch.cat([self.nu[k], torch.zeros_like(new[k])])
        n = new["xyz"].shape[0]
        self.radii = torch.cat([self.radii, self.radii.new_zeros(n)])

    def keep(self, rows: torch.Tensor) -> None:
        """_prune_optimizer: the rows of the mask ``rows`` stay."""
        for d in (self.params, self.mu, self.nu):
            for k in LEAVES:
                d[k] = d[k][rows]
        self.radii = self.radii[rows]


def densify_and_prune(params: dict, stats: dict, mu: dict, nu: dict,
                      noise: torch.Tensor, *, max_grad: float,
                      min_opacity: float, extent: float,
                      percent_dense: float, divide_ratio: float,
                      max_screen_size: float | None, abe_split: bool,
                      n_split: int = 2):
    """One round. Returns (params, mu, nu, statistics, counts): the new
    rows, their moments, zero statistics and {n_alive, abe, clones,
    splits, pruned}, ``pruned`` counting the split parents too."""
    g = Gaussians(dict(params), dict(mu), dict(nu), stats["max_radii2d"])
    n0 = len(g)
    grads = stats["xyz_gradient_accum"] / stats["denom"]
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    big = torch.exp(g.params["scaling"]).max(dim=1).values > \
        percent_dense * extent
    high = grads >= max_grad

    clone = high & ~big
    g.append({k: g.params[k][clone] for k in LEAVES})

    split = high & big
    n_abe = 0
    if abe_split:
        copy = {k: g.params[k][:n0][split] for k in LEAVES}
        copy["xyz"] = copy["xyz"] * 0.3 * extent
        g.append(copy)
        n_abe = int(split.sum())

    rows = torch.nonzero(split)[:, 0]
    scales = torch.exp(g.params["scaling"][rows])
    rots = rotation_matrix(g.params["rotation"][rows])
    children = []
    for s in range(n_split):
        samples = noise[s, rows] * scales
        offset = torch.bmm(rots, samples[:, :, None])[:, :, 0]
        children.append({
            "xyz": g.params["xyz"][rows] + offset,
            "features_dc": g.params["features_dc"][rows],
            "features_rest": g.params["features_rest"][rows],
            "scaling": torch.log(scales / (divide_ratio * n_split)),
            "rotation": g.params["rotation"][rows],
            "opacity": g.params["opacity"][rows]})
    g.append({k: torch.stack([c[k] for c in children], 1).flatten(0, 1)
              for k in LEAVES})
    parents = torch.zeros(len(g), dtype=torch.bool, device=grads.device)
    parents[:n0] = split
    g.keep(~parents)

    prune = torch.sigmoid(g.params["opacity"][:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (g.radii > max_screen_size) | \
            (torch.exp(g.params["scaling"]).max(dim=1).values >
             0.1 * extent)
    g.keep(~prune)

    n = len(g)
    counts = {"n_alive": n, "abe": n_abe, "clones": int(clone.sum()),
              "splits": int(split.sum()),
              "pruned": int(split.sum()) + int(prune.sum())}
    zero = g.params["xyz"].new_zeros(n)
    return (g.params, g.mu, g.nu, {k: zero for k in STATS}, counts)


def reset_opacity(opacity: torch.Tensor) -> torch.Tensor:
    """The opacity reset's logits (gaussian_model.py:200-203)."""
    o = torch.minimum(torch.sigmoid(opacity),
                      torch.ones_like(opacity) * 0.01)
    return torch.log(o / (1 - o))
