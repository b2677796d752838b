"""Layout algebra, twiddle tables and the plain pencil FFTs."""
