"""Traffic generators, made from ``--seed`` alone."""
