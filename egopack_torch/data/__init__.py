"""Graph structure of the tasks (numpy)."""
