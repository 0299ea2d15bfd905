"""The heart-failure ensemble port's benchmark (see README.md)."""
