"""Dashboard: only the host-stats reporter is ported so far (the runtime
samples it); the HTTP head is ROADMAP Queue A item 10."""
