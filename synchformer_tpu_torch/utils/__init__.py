"""Weight conversion and seeded initialisation."""
