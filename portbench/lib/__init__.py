"""The benchmark's own library: file lookup, traffic, weights, trace
reduction, FLOP counts and statistics."""
