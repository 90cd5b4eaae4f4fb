"""The one general generator of the benchmark's inputs, driven by a
configuration's and a traffic mix's parameters and by ``--seed``: rows
and queries from a seeded Gaussian mixture (the shape of the port's
``data/synthetic.make_corpus``: cluster centres N(0, 1.5^2), rows a
centre plus N(0, 1)), drawn on the device. Every seed draws the same
number of rows and queries: a seed changes which work is done and not how
much."""
from __future__ import annotations

import torch


def mixture(n: int, dim: int, clusters: int, center_scale: float,
            gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [n, dim] fp32, centres [clusters, dim]) on ``device``."""
    centers = torch.randn(clusters, dim, generator=gen, device=device) \
        * center_scale
    return draw_near(centers, n, gen), centers


def draw_near(centers: torch.Tensor, n: int, gen: torch.Generator
              ) -> torch.Tensor:
    """``n`` fresh rows of the mixture around ``centers``."""
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen,
                           device=centers.device)
    rows = torch.randn(n, centers.shape[1], generator=gen,
                       device=centers.device)
    return rows.add_(centers[assign])
