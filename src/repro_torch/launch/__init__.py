"""Launchers: ``index`` (the streaming index-creation job,
``python -m repro_torch.launch.index``) and ``serve`` (the online search
service over a built or restored index, ``python -m
repro_torch.launch.serve``)."""
