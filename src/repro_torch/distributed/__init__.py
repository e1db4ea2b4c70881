"""The job level of the index pipeline: the checkpoint format, the wave
scheduler (retries, wave statistics, checkpoint/resume) and deterministic
failure injection."""
