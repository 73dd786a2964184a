"""Multi-device plumbing: 1D meshes as ``torch.distributed`` process
groups (:mod:`.mesh`) and the frontier collectives over them
(:mod:`.collectives`)."""
