"""Host-side runtime mechanisms of the port: preemption and retry."""
