"""Text layout, view transforms and page rendering."""
