"""Halo catalogs from DBSCAN labels (port of ``repro/halos``)."""
