"""The planar coder's elementwise ops: u64 arithmetic on int64 bit
patterns (:mod:`.u64`), the closed-form per-symbol transition
(:mod:`.transition`) and the table lookups and code windows
(:mod:`.lookup`)."""
