"""Benchmark data for ALA: the cached datasets and the serving sweep."""
