"""The port's REST daemon: the App and its routes (app.py) over the
threaded keep-alive server (http.py), with the envelope codes (codes.py)."""
