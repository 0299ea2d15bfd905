"""Operation and byte counts from shapes, and the peaks."""
