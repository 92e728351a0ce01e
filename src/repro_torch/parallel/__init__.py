"""Halo distribution on a grid of tiles (``halo``), ported from the JAX
package's ``parallel/``."""
from repro_torch.parallel.halo import (TileMesh, exchange_1d,
                                       exchange_halo_2d, make_mesh)

__all__ = ["TileMesh", "exchange_1d", "exchange_halo_2d", "make_mesh"]
