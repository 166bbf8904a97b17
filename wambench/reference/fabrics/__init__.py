"""Plain builders of the fabrics the configurations name, one module per
``fabric`` kind: ``leaves(sizes)`` and ``build(sizes, links, pairs)``,
which returns the routing matrix and the per-link arrays in numpy."""
