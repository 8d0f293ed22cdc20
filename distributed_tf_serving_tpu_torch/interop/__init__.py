"""Interop with the TF-Serving model layout. Ported so far: `export.py
publish_version`, the atomic publish of an artifact into the next numeric
version directory of a base path (what a VersionWatcher loads). The
SavedModel import and export are not ported yet."""
