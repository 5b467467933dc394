"""The research configurations, built from the port only."""
