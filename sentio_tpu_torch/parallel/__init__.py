"""Host-side batching helpers, and the serving mesh: its geometry
(:mod:`.mesh`), the sharding rules (:mod:`.sharding`) and the collectives
one process runs over it (:mod:`.collectives`)."""
