"""General harness code: traffic, weights, stand-ins, work counters, trace reading and the cell drivers."""
