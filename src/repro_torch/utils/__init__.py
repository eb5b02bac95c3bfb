"""Small helpers shared by the port's packages."""
