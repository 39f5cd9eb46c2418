"""NequIP [arXiv:2101.03164] — E(3)-equivariant interatomic potential.

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3) tensor-product
message passing. Assigned GNN shapes include non-molecular graphs; we
synthesize 3-D positions there (DESIGN.md §3).

A copy of `repro.configs.nequip`: the port imports nothing of `repro`.
"""
from repro_torch.configs.base import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(
        name="nequip",
        family="gnn",
        n_layers=5,
        d_hidden=32,
        l_max=2,
        n_rbf=8,
        cutoff=5.0,
        d_out=1,
        n_species=64,
    )
