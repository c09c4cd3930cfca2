"""The CLI parser (shared with the JAX package) and static config assembly."""
