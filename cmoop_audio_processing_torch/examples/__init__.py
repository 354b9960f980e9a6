"""The repo's validation scripts on the port (copies of examples/*.py):
``run_exhaustive`` (the 288-genome ground truth of both templates),
``run_all8`` (the 8 method variants and the ordering verdict) and the two
corpus makers. Each runs as ``python -m
cmoop_audio_processing_torch.examples.<name>``."""
