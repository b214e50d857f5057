"""Training stage; so far only the serving half of the checkpoints."""
