"""Halo analysis from DBSCAN labels (port of ``repro/halos``): the halo
catalog (``catalog.py``), most-bound-particle centers (``centers.py``)
and spherical-overdensity masses (``so_mass.py``). The sharded catalog
merge of ``repro/halos/merge.py`` is ROADMAP A12."""
from repro_torch.halos.catalog import HaloCatalog, halo_catalog
from repro_torch.halos.centers import MostBoundResult, most_bound_centers
from repro_torch.halos.so_mass import SoMassResult, so_masses, so_masses_from_counts

__all__ = [
    "HaloCatalog",
    "halo_catalog",
    "MostBoundResult",
    "most_bound_centers",
    "SoMassResult",
    "so_masses",
    "so_masses_from_counts",
]
