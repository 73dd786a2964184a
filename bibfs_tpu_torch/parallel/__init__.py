"""Multi-device plumbing: 1D and 2D meshes as ``torch.distributed``
process groups (:mod:`.mesh`), the frontier collectives over them
(:mod:`.collectives`), the persistent rank pool (:mod:`.pool`) and the
pod's control plane, one replica across processes that joined by
themselves (:mod:`.podmesh`)."""
