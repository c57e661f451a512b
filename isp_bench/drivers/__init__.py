"""Traffic drivers: a module a kind of traffic, named by ``traffic/<mix>.json``."""
