"""Release loading for the port (training arrives in a later slice)."""
