"""The mesh tiers: the solve with its node axis split over shards
(`sharded`), and the federated and cross-region solvers built on it
(`federated`)."""
