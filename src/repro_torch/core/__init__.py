"""Spatial core of the port: geometry, Morton codes, LBVH, queries, DBSCAN."""
