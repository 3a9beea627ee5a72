"""Read sets routed through the port's device backend."""
