"""One module per kind of traffic (a traffic file's "kind"): it sets the
program up, runs the window and hands back what the metrics and the check
read."""
