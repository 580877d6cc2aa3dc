"""Walkthroughs of the port's API (twins of the repository's examples/):
`explore_data` (the simulator's batches), `analyze_results` (one
injection's posterior and its result object) and `toy_2d_npe` (a chirp
mass / mass ratio RealNVP trained end to end). Each runs as
`python -m posteriflow_torch.examples.<name> [--device cpu]`."""
