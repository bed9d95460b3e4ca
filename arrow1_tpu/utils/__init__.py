"""Shared utilities (the reference's arrow/util/ analogue).

Most of that directory's content (bitmaps, SIMD dispatch, futures)
dissolved into the columnar device design (see COMPONENTS.md); what
remains lives here: ``tzif`` (time-zone database reader).
"""
