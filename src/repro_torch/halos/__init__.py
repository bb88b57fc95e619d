"""Halo analysis from DBSCAN labels (port of ``repro/halos``): the halo
catalog (``catalog.py``), most-bound-particle centers (``centers.py``),
spherical-overdensity masses (``so_mass.py``) and the sharded catalog
merge and halo pipeline (``merge.py``)."""
from repro_torch.halos.catalog import HaloCatalog, halo_catalog
from repro_torch.halos.centers import MostBoundResult, most_bound_centers
from repro_torch.halos.merge import (
    HaloPipelineResult,
    PartialCatalog,
    finalize_rmax,
    halo_catalog_sharded,
    halo_pipeline_sharded,
    halo_pipeline_traced,
    local_rmax2,
    merge_partial_catalogs,
    partial_catalog,
    particle_slots,
)
from repro_torch.halos.so_mass import SoMassResult, so_masses, so_masses_from_counts

__all__ = [
    "HaloCatalog",
    "halo_catalog",
    "MostBoundResult",
    "most_bound_centers",
    "SoMassResult",
    "so_masses",
    "so_masses_from_counts",
    "PartialCatalog",
    "HaloPipelineResult",
    "partial_catalog",
    "merge_partial_catalogs",
    "local_rmax2",
    "particle_slots",
    "finalize_rmax",
    "halo_catalog_sharded",
    "halo_pipeline_sharded",
    "halo_pipeline_traced",
]
