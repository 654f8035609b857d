"""requests_per_s: requests answered within the window, divided by the
window's length (host clock). A request answered after the window closes is
checked, but not counted here."""


def read(rec):
    return rec.completed / rec.seconds if rec.seconds > 0 else None
