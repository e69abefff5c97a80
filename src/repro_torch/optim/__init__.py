"""AdamW with schedules and global-norm clipping, and int8 error-feedback
gradient compression, on the port's param trees."""
