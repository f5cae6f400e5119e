"""REST and serving services of the port."""
