"""Array operations of the graph stage and the solve tail."""
