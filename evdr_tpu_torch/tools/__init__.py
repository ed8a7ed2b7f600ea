"""Command-line tools of the torch port: convert_packed, search, serve_http."""
