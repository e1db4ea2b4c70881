"""Launchers: ``serve`` (the online search service over a built or restored
index, ``python -m repro_torch.launch.serve``)."""
