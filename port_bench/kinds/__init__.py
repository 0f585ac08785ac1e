"""One module a traffic `kind`, found by name: `serve_volumes`,
`train_steps`."""
