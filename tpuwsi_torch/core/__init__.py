"""Device selection for the port."""
