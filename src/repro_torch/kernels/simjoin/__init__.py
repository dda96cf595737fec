"""L1 similarity-join kernels (dense and pair-list grids), their entry
points, the host-side block pruning that feeds them, and the oracle."""
