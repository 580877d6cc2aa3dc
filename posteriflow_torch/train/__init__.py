"""Release loading, the NPE trainer and the PriorityNet trainer."""
